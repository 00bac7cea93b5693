"""Device-side primitive ops."""

from .class_means import fold_prototypes, masked_class_means
from .confmat import confusion_matrix
from .image_pool import ImagePool
from .pool import global_avg_pool, max_pool_ceil
from .resize import (resize_bilinear, resize_nearest, sample_bilinear_at,
                     upsample_logits)
from .ssim import ssim

__all__ = ["fold_prototypes", "masked_class_means", "confusion_matrix",
           "ImagePool", "global_avg_pool", "max_pool_ceil", "resize_bilinear",
           "resize_nearest", "sample_bilinear_at", "upsample_logits", "ssim"]
