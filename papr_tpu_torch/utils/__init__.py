from .logging import Logger, setup_seed, snapshot_code  # noqa: F401
from .metrics import psnr_np, ssim_np  # noqa: F401
