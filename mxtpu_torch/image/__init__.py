"""mx.image: host decode, resize, crops, augmenters and ``ImageIter``, and
the detection pipeline (the ``DetAugmenter`` family,
``CreateDetAugmenter``, ``ImageDetIter``); port of ``mxtpu/image``."""

from .image import (DECODE_ROUTE, Augmenter, CastAug, CenterCropAug,
                    ColorJitterAug, CreateAugmenter, ForceResizeAug,
                    HorizontalFlipAug, ImageIter, RandomCropAug, ResizeAug,
                    center_crop, color_normalize, fixed_crop, imdecode,
                    imread, imresize, random_crop, resize_short)
from .detection import (CreateDetAugmenter, CreateMultiRandCropAugmenter,
                        DetAugmenter, DetBorrowAug, DetHorizontalFlipAug,
                        DetRandomCropAug, DetRandomPadAug, DetRandomSelectAug,
                        ImageDetIter)

__all__ = ["DECODE_ROUTE", "Augmenter", "CastAug", "CenterCropAug",
           "ColorJitterAug", "CreateAugmenter", "ForceResizeAug",
           "HorizontalFlipAug", "ImageIter", "RandomCropAug", "ResizeAug",
           "center_crop", "color_normalize", "fixed_crop", "imdecode",
           "imread", "imresize", "random_crop", "resize_short",
           "CreateDetAugmenter", "CreateMultiRandCropAugmenter",
           "DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "DetRandomSelectAug",
           "ImageDetIter"]
