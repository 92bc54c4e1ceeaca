"""Region-feature extraction: the JAX package's `tools/img_feat_extract.py`
(reference `tools/img_feat_extract.py`) on the port's detectors.

Runs a detector over an image directory (`.jpg`, `.jpeg`, `.png`, `.bmp`,
sorted by name) and writes the framework's feature contract:
`predictions.tsv` rows [image_name, json{"feature": base64 float32
[N, 2054], "predictions": tags}] with its `.lineidx`, and
`imageid2idx.json`. On the card unless `--platform cpu`:

    python -m mvp_pytorch_tpu_torch.tools.img_feat_extract \
        --image_dir imgs/ --target_dir out/ [--od_ckpt ckpt_dir]

Backends: the port's detector (`--od_ckpt`, a `detection.train_cli`
checkpoint; seeded weights without one), batched `--batch_size` images a
forward; or a TorchScript detector (`--vinvl_od_path od_model.pt
--od_config_dir DIR`, the reference's artifact), one image a forward as in
the reference tool. Images stream through in chunks of max(batch, 256), so
the features of a whole directory are never held at once.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
from typing import List, Sequence

import numpy as np

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def feature_row(name: str, feats: np.ndarray, tags: Sequence[str]
                ) -> List[str]:
    """One `predictions.tsv` row: [name, json{"feature": base64 of the
    float32 [N, 2054] array, "predictions": tags}]."""
    enc = base64.b64encode(np.asarray(feats, np.float32).tobytes()
                           ).decode("utf-8")
    return [name, json.dumps({"feature": enc, "predictions": list(tags)})]


def write_features(target_dir: str, names: Sequence[str], rows) -> str:
    """`predictions.tsv` (+ `.lineidx`) from `rows` and `imageid2idx.json`
    for `names`, in `target_dir`; returns the TSV's path."""
    from ..data.tsv import tsv_writer
    os.makedirs(target_dir, exist_ok=True)
    tsv_path = os.path.join(target_dir, "predictions.tsv")
    tsv_writer(rows, tsv_path)
    with open(os.path.join(target_dir, "imageid2idx.json"), "w") as f:
        json.dump({name: i for i, name in enumerate(names)}, f)
    return tsv_path


def get_args(argv=None):
    p = argparse.ArgumentParser(description="region-feature extraction")
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--target_dir", type=str, required=True)
    p.add_argument("--vinvl_od_path", type=str, default=None,
                   help="a TorchScript detector; omit for the port's own")
    p.add_argument("--od_ckpt", type=str, default=None,
                   help="the port's detector checkpoint dir "
                        "(detection.train_cli, frontend.save_detector)")
    p.add_argument("--label_map", type=str, default=None,
                   help="VG-SGG-dicts json for tag names")
    p.add_argument("--od_config_dir", type=str, default="tools_tpu/configs/")
    p.add_argument("--batch_size", type=int, default=8,
                   help="images a device forward (the port's detector; a "
                        "TorchScript detector runs one image a forward, as "
                        "the reference tool)")
    p.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Extract and write; returns the TSV's path."""
    args = get_args(argv)
    if args.vinvl_od_path:
        from ..pipeline import make_torchscript_od
        od = make_torchscript_od(args.vinvl_od_path, args.od_config_dir,
                                 args.platform)
    else:
        from ..detection import DetectionFrontend
        od = DetectionFrontend(ckpt_dir=args.od_ckpt,
                               label_map=args.label_map,
                               device=args.platform)
    images = sorted(f for f in os.listdir(args.image_dir)
                    if f.lower().endswith(IMAGE_SUFFIXES))
    bs = max(1, args.batch_size) if hasattr(od, "batch_call") else 1
    chunk_imgs = max(bs, 256)

    def rows():
        for start in range(0, len(images), chunk_imgs):
            names = images[start:start + chunk_imgs]
            paths = [os.path.join(args.image_dir, n) for n in names]
            if bs > 1:
                results = od.batch_call(paths, batch_size=bs)
            else:
                results = (od(p) for p in paths)
            for name, (feats, tags) in zip(names, results):
                yield feature_row(name, feats, tags)

    tsv_path = write_features(args.target_dir, images, rows())
    print(f"wrote {tsv_path} ({len(images)} images)")
    return tsv_path


if __name__ == "__main__":
    main()
