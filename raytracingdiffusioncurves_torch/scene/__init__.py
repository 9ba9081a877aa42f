from .xml_loader import AttrTable, SceneTables, load_scene, load_scene_from_string
from .device import DeviceScene, build_device_scene, from_jax_arrays

__all__ = [
    "AttrTable", "SceneTables", "load_scene", "load_scene_from_string",
    "DeviceScene", "build_device_scene", "from_jax_arrays",
]
