from .dataset import SceneGraphBundle, SceneGraphData, build_tensors, load_data
from .loader import Batches, pad_batch, prefetch_to_device

__all__ = ["Batches", "SceneGraphBundle", "SceneGraphData", "build_tensors", "load_data",
           "pad_batch", "prefetch_to_device"]
