"""InferencePipeline, the public quick-start API: the JAX package's
`pipeline.py` on one device (reference `oscar/modeling/modeling_pipeline.py`).

`InferencePipeline('mlm' | 'embedding', model_dir, object_detector=...)`
loads a model directory in the port's format (`config.json`,
`pytorch_model.bin`, `vocab.txt`) onto the card (or the CPU when asked) once,
then serves image-text pairs:
- `prepare_batch` / `prepare_example`: host work only (region features and
  tags from the detector backend, SPICE phrases, tensorization);
- `infer_prepared`: pads each chunk to `batch_size`, copies the collated
  batch to the device and runs the batched forward; in
  `mlm` mode it takes the argmax over the vocabulary on the device and
  brings back `[B, La]` token ids, never the logits;
- `decode_mlm`, `inference_batch` and `inference` on top of them.

Detector backends (`object_detector`): a `FeatureStore` (region features
looked up by image id or file name); a callable `img_path -> (features
[N, 2054], tags)`; `'torch'` or `'torch:<ckpt_dir>'`, the port's detector
(`detection.DetectionFrontend`, seeded or from a `detection.train_cli`
checkpoint) on the pipeline's device, its tag names from
`od_config_dir/VG-SGG-dicts-vgoi6-clipped.json` when that exists; or the
path of a TorchScript detector (the reference's VinVL artifact, with
`vinvl_transform.json` and the label map in `od_config_dir`), also on the
pipeline's device. The JAX package's specs (`'jax'`, `'jax:<ckpt>'`) raise:
a JAX detector checkpoint is carried over with `convert.detector_state_dict`
where both packages are installed. A backend with `batch_call` (the port's
detector) runs a batch of images in one forward.

A pretraining checkpoint (`tasks.pretrain`) serves as it is: keys of heads
the mode's model lacks (the ITM and QA heads, `half_mlm`, `logit_scale`) are
dropped and named in one log line, as the JAX pipeline ignores them; a key
the model needs and the checkpoint lacks raises.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import tempfile
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .data.datasets import FeatureStore
from .data.tensorize import TensorizeConfig, collate, tensorize_example
from .data.tokenization import FastBertTokenizer
from .models.config import ModelConfig
from .models.layers import resolve_device
from .models.tasks import MLMModel, RepModel
from .training.checkpoint import WEIGHTS_NAME
from .training.loop import batch_on

MODEL_NAME_MAPPING = {"mlm": MLMModel, "embedding": RepModel}
# the data plane's names of the model's seven inputs, in the models' order
MODEL_INPUTS = ("input_ids_a", "input_mask_a", "segment_ids_a", "input_ids_b",
           "input_mask_b", "segment_ids_b", "img_feat")
LABEL_MAP_NAME = "VG-SGG-dicts-vgoi6-clipped.json"
_JAX_DETECTOR = ("object detector {!r} is the JAX package's; the port's "
                 "detector is 'torch[:<ckpt_dir>]'. Carry a JAX detector "
                 "checkpoint over with mvp_pytorch_tpu_torch.convert."
                 "detector_state_dict where both packages are installed")

logger = logging.getLogger(__name__)


def load_for_serving(model: torch.nn.Module, path: str,
                     log: Callable[[str], None] = logger.info) -> None:
    """Load `pytorch_model.bin` at `path` into `model` on its device. A key
    the model needs and the file lacks raises; keys of heads the model lacks
    are dropped and named in one `log` line."""
    state = torch.load(path, map_location=next(model.parameters()).device,
                       weights_only=True)
    res = model.load_state_dict(state, strict=False)
    if res.missing_keys:
        raise RuntimeError(f"{path} lacks keys the model needs: "
                           f"{sorted(res.missing_keys)}")
    if res.unexpected_keys:
        log(f"{os.path.basename(path)}: dropped {len(res.unexpected_keys)} "
            f"keys of heads the {type(model).__name__} lacks: "
            f"{sorted(res.unexpected_keys)}")


def make_torchscript_od(od_path: str, od_config_dir: str, device="cuda"
                        ) -> Callable:
    """A TorchScript VinVL-style detector (reference
    modeling_pipeline.py:31-43, 66-88) on `device`: `img_path -> (features
    [N, 2054], tags)`. The module takes a CHW image batch [1, 3, H, W] (the
    `vinvl_transform.json` transform of `od_config_dir`) and returns
    (bboxes [1, N, 4] in pixels, tag ids [1, N], features [1, N, 2048]);
    tags are named by `od_config_dir/VG-SGG-dicts-vgoi6-clipped.json`."""
    from .tools.transforms import build_transforms
    device = resolve_device(device)
    od_model = torch.jit.load(od_path, map_location=device)
    od_model.eval()
    with open(os.path.join(od_config_dir, "vinvl_transform.json")) as f:
        transform = build_transforms(json.load(f))
    with open(os.path.join(od_config_dir, LABEL_MAP_NAME)) as f:
        label_map = {v: k for k, v in json.load(f)["label_to_idx"].items()}

    def run(img_path: str) -> Tuple[np.ndarray, List[str]]:
        from PIL import Image
        x = transform(Image.open(img_path).convert("RGB"))
        img_h, img_w = x.shape[-2:]
        with torch.no_grad():
            bboxes, tag_ids, feats = od_model(
                torch.from_numpy(np.ascontiguousarray(x[None])).to(device))
        bboxes = bboxes[0].cpu().numpy().copy()
        feats = feats[0].float().cpu().numpy()
        tags = [label_map[int(t)] for t in tag_ids[0].cpu().numpy()]
        bboxes[:, [0, 2]] /= img_w
        bboxes[:, [1, 3]] /= img_h
        w = (bboxes[:, 2] - bboxes[:, 0])[:, None]
        h = (bboxes[:, 3] - bboxes[:, 1])[:, None]
        full = np.concatenate([feats, bboxes, w, h], axis=1)
        return full.astype(np.float32), tags
    return run


def make_object_detector(spec: str, od_config_dir: str, device="cuda"
                         ) -> Callable:
    """A detector backend from its string spec: 'torch[:<ckpt_dir>]' (the
    port's detector) or a TorchScript path; 'jax[:<ckpt>]' raises."""
    if spec == "jax" or spec.startswith("jax:"):
        raise ValueError(_JAX_DETECTOR.format(spec))
    if spec == "torch" or spec.startswith("torch:"):
        from .detection import load_frontend
        lm = os.path.join(od_config_dir, LABEL_MAP_NAME)
        return load_frontend(spec, lm if os.path.exists(lm) else None,
                             device=device)
    return make_torchscript_od(spec, od_config_dir, device)


class InferencePipeline:
    def __init__(self, model_name: str, model_path: str,
                 object_detector: Union[str, Callable, FeatureStore,
                                        None] = None,
                 od_config_dir: str = "tools_tpu/configs/",
                 parser_path: str = "tools_tpu/spice",
                 id2phrase: Optional[str] = None,
                 max_seq_length: int = 30, max_img_seq_length: int = 50,
                 max_tag_length: int = 20, max_phrases: int = 5, *,
                 device="cuda"):
        if model_name not in MODEL_NAME_MAPPING:
            raise ValueError(f"{model_name} not in valid names: "
                             f"{', '.join(MODEL_NAME_MAPPING)}")
        self.model_name = model_name
        self.device = resolve_device(device)
        self.config = ModelConfig.from_pretrained(model_path)
        self.model = MODEL_NAME_MAPPING[model_name](self.config,
                                                    device=self.device)
        load_for_serving(self.model, os.path.join(model_path, WEIGHTS_NAME))
        self.model.eval()
        self.tokenizer = FastBertTokenizer.from_pretrained(model_path)
        self.mask_id = self.tokenizer.vocab["[MASK]"]
        self.tcfg = TensorizeConfig(
            max_seq_length=max_seq_length, max_tag_length=max_tag_length,
            max_img_seq_length=max_img_seq_length, max_phrases=max_phrases,
            img_feature_dim=self.config.img_feature_dim)

        self._od: Optional[Callable] = None
        if isinstance(object_detector, FeatureStore):
            store = object_detector
            self._od = lambda p: store.get(os.path.basename(p))
        elif callable(object_detector):
            self._od = object_detector
        elif isinstance(object_detector, str):
            self._od = make_object_detector(object_detector, od_config_dir,
                                            self.device)

        self.parser_path = parser_path
        self.phrase_cache_dir = os.path.join(tempfile.gettempdir(),
                                             "mvptr_spice")
        self.sg2id: Dict[tuple, int] = {}
        if id2phrase and os.path.exists(id2phrase):
            with open(id2phrase) as f:
                self.sg2id = {tuple(v): int(k)
                              for k, v in json.load(f).items()}

    # ------------------------------------------------------------- host
    def preprocess_img(self, img_path: str):
        if self._od is None:
            raise RuntimeError("no object-detection backend configured: pass "
                               "a FeatureStore or a callable")
        return self._od(img_path)

    def phrase_extract(self, text: str) -> List[int]:
        """SPICE scene-graph parse -> phrase vocab ids; [] without the jar
        or a phrase vocabulary."""
        return self.phrase_extract_batch([text])[0]

    def phrase_extract_batch(self, texts) -> List[List[int]]:
        """One SPICE JVM run parses all texts. Without `spice-1.0.jar` under
        `parser_path` or an id2phrase vocabulary, [] for each text: the jar
        is never fetched."""
        jar = os.path.join(self.parser_path, "spice-1.0.jar")
        if not os.path.exists(jar) or not self.sg2id:
            return [[] for _ in texts]
        os.makedirs(self.phrase_cache_dir, exist_ok=True)
        # per-call files: concurrent pipelines must not share names
        fd_in, tmp_in = tempfile.mkstemp(suffix=".json", prefix="spice_in_",
                                         dir=self.phrase_cache_dir)
        fd_out, tmp_out = tempfile.mkstemp(suffix=".json",
                                           prefix="spice_out_",
                                           dir=self.phrase_cache_dir)
        os.close(fd_out)
        try:
            with os.fdopen(fd_in, "w") as f:
                json.dump([{"image_id": str(i), "test": t.lower(),
                            "refs": []} for i, t in enumerate(texts)], f)
            subprocess.run(
                ["java", "-Xmx8G", "-jar", jar, tmp_in, "-out", tmp_out,
                 "-threads", "20", "-detailed", "-silent"], check=True,
                timeout=600)
            with open(tmp_out) as f:
                parsed = json.load(f)
        finally:
            for p in (tmp_in, tmp_out):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        by_id = {str(r.get("image_id", i)): r for i, r in enumerate(parsed)}
        out = []
        for i in range(len(texts)):
            nodes = [tuple(t["tuple"])
                     for t in by_id.get(str(i), {}).get("test_tuples", [])]
            out.append([self.sg2id[t] for t in nodes if t in self.sg2id])
        return out

    def tensorize_example(self, text_a, img_feat, text_b="",
                          phrase_nodes=None):
        return tensorize_example(self.tokenizer, text_a, np.asarray(img_feat),
                                 text_b, phrase_nodes, self.tcfg)

    def prepare_batch(self, pairs, batch_size: int = 16):
        """Host stage: features and tags, phrases and tensorization for
        pairs = [(img_path, text), ...]; safe on request threads. A detector
        with `batch_call` runs `batch_size` images a forward."""
        paths = [p for p, _ in pairs]
        if hasattr(self._od, "batch_call"):
            od_out = self._od.batch_call(paths, batch_size=batch_size)
        else:
            od_out = [self.preprocess_img(p) for p in paths]
        phrase_lists = self.phrase_extract_batch([t for _, t in pairs])
        return [self.tensorize_example(text, feat, " ".join(tags), ph)
                for (feat, tags), (_, text), ph in zip(od_out, pairs,
                                                       phrase_lists)]

    def prepare_example(self, img_path: str, text: str):
        return self.prepare_batch([(img_path, text)], batch_size=1)[0]

    # ----------------------------------------------------------- device
    @torch.no_grad()
    def forward_batch(self, batch: Dict[str, np.ndarray]):
        """The mode's batched forward over a collated batch: `[B, La]`
        argmax ids (int64, on the device) for mlm, the four outputs for
        embedding."""
        x = batch_on(self.device, batch, MODEL_INPUTS)
        out = self.model(*(x[k] for k in MODEL_INPUTS),
                         max_tag_length=self.tcfg.max_tag_length)
        return out.argmax(-1) if self.model_name == "mlm" else out

    def infer_prepared(self, exs, batch_size: int = 16):
        """Device stage: each chunk padded to `batch_size` (its last example
        repeated) and run by `forward_batch`. Per example: the `[La]`
        argmax ids for mlm (decode with `decode_mlm`), a {name: array} dict
        for embedding."""
        results = []
        for i in range(0, len(exs), batch_size):
            chunk = list(exs[i:i + batch_size])
            n = len(chunk)
            chunk += [chunk[-1]] * (batch_size - n)
            out = self.forward_batch(collate(chunk))
            if self.model_name == "mlm":
                ids = out[:n].cpu().numpy()
                results.extend(ids[j] for j in range(n))
            else:
                host = {k: v[:n].float().cpu().numpy()
                        for k, v in out.items()}
                results.extend({k: v[j] for k, v in host.items()}
                               for j in range(n))
        return results

    def decode_mlm(self, ex, pred_ids) -> List[str]:
        """The predicted tokens at the example's [MASK] positions (read from
        the host's tensorized example)."""
        mp = np.asarray(ex["input_ids_a"]) == self.mask_id
        return self.tokenizer.convert_ids_to_tokens(
            [int(p) for p in np.asarray(pred_ids)[mp]])

    def inference_batch(self, pairs, batch_size: int = 16):
        """Batched serving of pairs = [(img_path, text), ...]: mlm gives the
        recovered tokens per pair, embedding the output dicts."""
        exs = self.prepare_batch(pairs, batch_size=batch_size)
        raw = self.infer_prepared(exs, batch_size=batch_size)
        if self.model_name == "mlm":
            return [self.decode_mlm(ex, r) for ex, r in zip(exs, raw)]
        return raw

    def inference(self, img_path: str, text: str):
        """One pair at batch 1: a "recovered [MASK] tokens: [...]" string
        for mlm, the output dict for embedding."""
        ex = self.prepare_example(img_path, text)
        raw = self.infer_prepared([ex], batch_size=1)[0]
        if self.model_name == "mlm":
            return "recovered [MASK] tokens: {}".format(
                self.decode_mlm(ex, raw))
        return raw
