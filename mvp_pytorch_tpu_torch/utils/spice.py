"""SPICE caption metric — subprocess wrapper around spice-1.0.jar, the
port's copy of the JAX package's `utils/spice.py`.

Parity target: the reference reports SPICE through the COCO-caption
package's pyspice wrapper (reference `oscar/utils/caption_evaluate.py:59-92`
runs COCOEvalCap, whose scorer list includes Spice(); the jar itself comes
from `tools/prepare_spice.sh`). The jar is never fetched: this wrapper
implements the subprocess protocol with a clean skip-when-absent, and once
the jar is in place SPICE scores auto-enable everywhere
`evaluate_captions` is used.

Protocol (coco-caption `spice.py`):
  input json:  [{"image_id": i, "test": hypothesis, "refs": [ref, ...]}]
  invocation:  java -jar -Xmx8G spice-1.0.jar <in.json>
                    -cache <cache_dir> -out <out.json> -subset -silent
  output json: [{"image_id": i, "scores": {"All": {"f": ...}, ...}}]
  reported SPICE = mean of the All-F scores.

Jar discovery: $SPICE_JAR, then tools_tpu/spice/spice-1.0.jar, then
~/.cache/mvptr/spice/spice-1.0.jar.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence, Tuple, Union

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

JAR_NAME = "spice-1.0.jar"


def find_spice_jar() -> Optional[str]:
    """The parser's jar-discovery contract; None when no jar is present."""
    candidates = [
        os.environ.get("SPICE_JAR"),
        os.path.join(_REPO_ROOT, "tools_tpu", "spice", JAR_NAME),
        os.path.expanduser(os.path.join("~", ".cache", "mvptr", "spice",
                                        JAR_NAME)),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def _text(x: Union[str, Sequence[str]]) -> str:
    return x if isinstance(x, str) else " ".join(x)


class SpiceMetric:
    """Subprocess SPICE scorer with skip-when-absent semantics."""

    def __init__(self, jar: Optional[str] = None, java: str = "java",
                 cache_dir: Optional[str] = None, timeout: float = 1800.0,
                 heap: str = "8G"):
        self.jar = jar if jar is not None else find_spice_jar()
        self.java = java
        self.cache_dir = cache_dir or os.path.expanduser(
            os.path.join("~", ".cache", "mvptr", "spice_cache"))
        self.timeout = timeout
        self.heap = heap

    @property
    def available(self) -> bool:
        return bool(self.jar) and os.path.exists(self.jar)

    def status(self) -> str:
        """Explicit availability report (the 'jar absent' message the
        caller can surface instead of silently dropping the metric)."""
        if self.available:
            return f"spice jar: {self.jar}"
        return (f"spice jar absent (searched $SPICE_JAR, "
                f"tools_tpu/spice/{JAR_NAME}, ~/.cache/mvptr/spice/"
                f"{JAR_NAME}) — SPICE not reported; fetch with the "
                f"reference's tools/prepare_spice.sh contract")

    def compute(self, candidates: Sequence[Union[str, Sequence[str]]],
                references: Sequence[Sequence[Union[str, Sequence[str]]]]
                ) -> Optional[Tuple[float, List[float]]]:
        """(mean All-F, per-example All-F) or None when the jar is absent."""
        if not self.available:
            return None
        payload = [{"image_id": i, "test": _text(c),
                    "refs": [_text(r) for r in refs]}
                   for i, (c, refs) in enumerate(zip(candidates,
                                                     references))]
        os.makedirs(self.cache_dir, exist_ok=True)
        fd_in, tmp_in = tempfile.mkstemp(suffix=".json", prefix="spice_in_")
        fd_out, tmp_out = tempfile.mkstemp(suffix=".json",
                                           prefix="spice_out_")
        os.close(fd_out)
        try:
            with os.fdopen(fd_in, "w") as f:
                json.dump(payload, f)
            subprocess.run(
                [self.java, f"-Xmx{self.heap}", "-jar", self.jar, tmp_in,
                 "-cache", self.cache_dir, "-out", tmp_out, "-subset",
                 "-silent"],
                check=True, timeout=self.timeout,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            with open(tmp_out) as f:
                results = json.load(f)
            by_id = {int(r["image_id"]): float(r["scores"]["All"]["f"])
                     for r in results}
            scores = [by_id.get(i, 0.0) for i in range(len(payload))]
            mean = sum(scores) / max(len(scores), 1)
            return mean, scores
        finally:
            for p in (tmp_in, tmp_out):
                try:
                    os.remove(p)
                except OSError:
                    pass


__all__ = ["SpiceMetric", "find_spice_jar", "JAR_NAME"]
