"""Host ms a step of the trainer's `trainer.backward` span: the main thread
in `loss.backward()` while the autograd engine launches the backward (the
median over the untraced window's steps; `host_fwd_ms.train.py`)."""

import os

from benchmark import harness

_fwd = harness.load_module(os.path.join(os.path.dirname(__file__),
                                        "host_fwd_ms.train.py"))


def read(r):
    return _fwd.span_median(r, "train_step", "trainer.backward", 1e-6)
