"""mx.image: host decode, resize, crops, augmenters and ``ImageIter``
(port of ``mxtpu/image``; ``ImageDetIter`` and the detection augmenters
of ``mxtpu/image/detection.py`` are not ported yet)."""

from .image import (DECODE_ROUTE, Augmenter, CastAug, CenterCropAug,
                    ColorJitterAug, CreateAugmenter, ForceResizeAug,
                    HorizontalFlipAug, ImageIter, RandomCropAug, ResizeAug,
                    center_crop, color_normalize, fixed_crop, imdecode,
                    imread, imresize, random_crop, resize_short)

__all__ = ["DECODE_ROUTE", "Augmenter", "CastAug", "CenterCropAug",
           "ColorJitterAug", "CreateAugmenter", "ForceResizeAug",
           "HorizontalFlipAug", "ImageIter", "RandomCropAug", "ResizeAug",
           "center_crop", "color_normalize", "fixed_crop", "imdecode",
           "imread", "imresize", "random_crop", "resize_short"]
