from .dataset import Batch, Loader, RINDataset, extract_patches, get_dataset, get_loader  # noqa: F401
from .loaders import load_blender_data, load_meta_data, load_t2_data  # noqa: F401
