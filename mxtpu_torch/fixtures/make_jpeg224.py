#!/usr/bin/env python3
"""Make the JPEG fixture of the data path: 16 noise images, 224 x 224 x 3,
drawn one after another as ``rs.randint(0, 255, (224, 224, 3))`` from
``np.random.RandomState(0)`` (as the JAX package's ``bench.py``
``bench_train_e2e`` draws its records), encoded by the port's
``recordio.pack_img`` with Pillow at quality 90, and written as
``jpeg224/NN.jpg``; beside them ``jpeg224/decoded.json`` holds, for each
image, the SHA-256 of its file, the SHA-256 of its pixels as libjpeg
decodes them (the native IO library's ``jpeg_decode``) and the mean
absolute error of that decode against the source pixels.

    python3 mxtpu_torch/fixtures/make_jpeg224.py

Needs Pillow and libjpeg's headers (the native library must decode).
``chip_smoke.py`` packs its RecordIO file from these images and holds the
card machine's decode route to the JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jpeg224")
N, HW, QUALITY, SEED = 16, 224, 90, 0


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import PIL
    from mxtpu_torch import native, recordio
    if not native.HAVE_JPEG or not native.available():
        raise SystemExit("the native IO library must build with libjpeg "
                         f"(jpeglib.h: {native.jpeg_header()}, "
                         f"build: {native.build_error})")
    os.makedirs(OUT, exist_ok=True)
    rs = np.random.RandomState(SEED)
    images = []
    for i in range(N):
        src = rs.randint(0, 255, (HW, HW, 3)).astype(np.uint8)
        rec = recordio.pack_img(recordio.IRHeader(0, float(i), i, 0), src,
                                quality=QUALITY)
        _, jpeg = recordio.unpack(rec)
        name = f"{i:02d}.jpg"
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(jpeg)
        dec = native.jpeg_decode(jpeg)
        if dec is None or dec.shape != src.shape:
            raise SystemExit(f"libjpeg could not decode {name}")
        images.append({
            "file": name, "bytes": len(jpeg),
            "sha256_file": hashlib.sha256(jpeg).hexdigest(),
            "sha256_decoded": hashlib.sha256(dec.tobytes()).hexdigest(),
            "mae_vs_source": float(np.abs(dec.astype(np.int16)
                                          - src).mean())})
    meta = {"shape": [HW, HW, 3], "seed": SEED, "quality": QUALITY,
            "encoder": f"Pillow {PIL.__version__}",
            "decoder": "libjpeg (mxtpu_torch.native.jpeg_decode)",
            "images": images}
    with open(os.path.join(OUT, "decoded.json"), "w") as f:
        json.dump(meta, f, indent=1)
    total = sum(im["bytes"] for im in images)
    print(f"{N} JPEGs, {total} bytes, in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
