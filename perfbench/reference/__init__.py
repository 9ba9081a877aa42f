"""The comparison's plain reference: frozen copies of the renderer's plain
PyTorch paths (scene parsing and flattening, the full-sweep trace, the
post-processing and the UNet), taken so that a change to the program cannot
change what it is judged against.  Nothing here imports the program."""
