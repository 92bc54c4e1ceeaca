"""Detector training command line: the JAX package's
`detection/train_cli.py` on the port's detector.

Trains the detector on the synthetic coloured-rectangles corpus
(`synthetic_boxes.py`; a real detection corpus goes through the same
`Detector.loss`) and writes a checkpoint that the pipeline
(`object_detector='torch:<out_dir>'`), the extraction tool (`--od_ckpt`)
and `DetectionFrontend` load, with `train_history.json`. Runs on the card
unless `--platform cpu`:

    python -m mvp_pytorch_tpu_torch.detection.train_cli --out_dir det_ckpt \
        --steps 300 --canvas 256 [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description="train the detector on "
                                "synthetic boxes")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--canvas", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    p.add_argument("--log_every", type=int, default=20)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train and save; returns {"config", "loss": the history, "model"}."""
    args = get_args(argv)
    from ..utils.logger import setup_logger
    from .detector import DetectorConfig
    from .frontend import save_detector
    from .synthetic_boxes import COLORS, train_detector

    logger = setup_logger("detect_train", args.out_dir)
    config = DetectorConfig(canvas=args.canvas, num_classes=len(COLORS),
                            pre_nms_topk=min(256, (args.canvas // 16) ** 2),
                            max_regions=16)
    config, model, history = train_detector(
        config=config, steps=args.steps, batch=args.batch, lr=args.lr,
        seed=args.seed, log_every=args.log_every, logger=logger,
        device=args.platform)
    save_detector(args.out_dir, config, model)
    with open(os.path.join(args.out_dir, "train_history.json"), "w") as f:
        json.dump({"loss": history}, f)
    logger.info(f"saved detector to {args.out_dir} "
                f"(loss {history[0]:.3f} -> {history[-1]:.3f})")
    return dict(config=config, loss=history, model=model)


if __name__ == "__main__":
    main()
