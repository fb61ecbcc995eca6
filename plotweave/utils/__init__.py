"""I/O and logging helpers."""

from .io import (load_pickle, save_pickle, load_json, save_json, read_image,
                 write_image, register_device_artifact, fetch_device_artifact, thread_map,
                 register_derived_artifact, fetch_derived_artifact)

__all__ = ["load_pickle", "save_pickle", "load_json", "save_json", "read_image",
           "write_image", "register_device_artifact", "fetch_device_artifact", "thread_map",
           "register_derived_artifact", "fetch_derived_artifact"]
