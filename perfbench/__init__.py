"""The benchmark of raytracingdiffusioncurves_torch: run.py runs one cell
once (see core.py); configs/, traffic/, workloads/ and metrics/ hold the
cells, found by name."""
