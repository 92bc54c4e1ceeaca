"""Shared command-line plumbing for the port's task drivers: the JAX
package's `tasks/common.py` on one device, without JAX.

`add_common_args` declares the flags; `check_args` makes each flag of a
driver's own later items raise, naming the item (`LATER_ITEMS`, shared by
every driver, is empty: every common flag is ported); `run_device`
joins the process group when the launch has more than one rank or a
parallel flag asks for one (`parallel/distributed.py` `init_runtime`) and
picks the rank's device (CUDA, `cuda:{LOCAL_RANK}`, unless `--platform
cpu`; no card raises);
`build_config`, `load_params_or_init`, `restore_training_settings`,
`tensorize_cfg` and `synth_root` build what a driver needs; `TrainLoop` trains
over the dataset with the process loader (`data/loader.py`) through
`training/loop.py`, as one rank of a (data, model, pipe) mesh when the
process group exists: `--model_parallel N` cuts the model over N model
ranks (Megatron TP, and EP for MoE layers), `--sequence_parallel` adds SP,
`--pipeline_parallel N` pipelines a `pipeline_stages = N` model over N pipe
ranks (`--pipeline_microbatches`), `--fsdp` shards the parameters as well
as the AdamW moments (ZeRO-2, always on over the data ranks). Each data
rank loads its own rows of the global `--train_batch_size`; `predict`
shards eval examples over the data ranks and gathers them in rank order.
`TrainLoop` also takes the JAX loop's `--async_ckpt`, `--profile_dir` /
`--profile_start` / `--profile_steps` and its SIGTERM preemption checkpoint
(off with `--no_preempt_save`), and prints `EVALERR:` after an eval with an
accuracy.

For the task drivers (VQA, SNLI-VE, referring expressions; NLVR2 with its
second image side, `NLVR_INPUT_NAMES`): `TaskFetch` is their loader fetch,
`predict` their eval loop and `adjust_dropout` their `--adjust_dp_step`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loader import BatchSampler, ProcessLoader, _epoch_aware
from ..data.tensorize import TensorizeConfig
from ..models.config import ModelConfig
from ..models.layers import hidden_dropouts
from ..training.checkpoint import ARGS_NAME, WEIGHTS_NAME
from ..training.loop import batch_on, run_training

# the data plane's names of the model's seven inputs -> the model's, in the
# order the models take them
INPUT_NAMES = {"input_ids_a": "input_ids_a",
               "input_mask_a": "attention_mask_a",
               "segment_ids_a": "token_type_ids_a",
               "input_ids_b": "input_ids_b",
               "input_mask_b": "attention_mask_b",
               "segment_ids_b": "token_type_ids_b", "img_feat": "img_feats"}
MODEL_KEYS = tuple(INPUT_NAMES.values())
# NLVR2's eleven inputs: the pair's seven, then the second image's four
NLVR_INPUT_NAMES = {**INPUT_NAMES, "input_ids_b2": "input_ids_b2",
                    "input_mask_b2": "attention_mask_b2",
                    "segment_ids_b2": "token_type_ids_b2",
                    "img_feat2": "img_feats2"}
NLVR_MODEL_KEYS = tuple(NLVR_INPUT_NAMES.values())
# --adjust_dp_step's hidden dropout (the reference's `.p = 0.3`)
ADJUSTED_DROPOUT = 0.3

# flag -> (value that means "off", the ROADMAP queue 1 item it waits for):
# empty, every common flag is ported; a driver may pass its own to
# `check_args`
LATER_ITEMS: Dict[str, tuple] = {}


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model_name_or_path", type=str, default=None,
                        help="checkpoint dir (config.json + "
                             "pytorch_model.bin + vocab.txt)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="generate synthetic data into output_dir/synth")
    parser.add_argument("--do_train", action="store_true")
    parser.add_argument("--do_eval", action="store_true")
    parser.add_argument("--seed", type=int, default=88)
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--eval_batch_size", type=int, default=64)
    parser.add_argument("--learning_rate", type=float, default=4e-5)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=100)
    parser.add_argument("--num_train_epochs", type=float, default=None,
                        help="train for N epochs of the dataset instead of "
                             "--max_steps (steps/epoch = ceil(len(dataset) / "
                             "batch)); overrides --max_steps")
    parser.add_argument("--max_grad_norm", type=float, default=1.0)
    parser.add_argument("--adam_epsilon", type=float, default=1e-8)
    parser.add_argument("--classifier", type=str, default=None,
                        choices=["linear", "mlp"])
    parser.add_argument("--cls_hidden_scale", type=int, default=None)
    parser.add_argument("--scheduler", type=str, default="linear",
                        choices=["linear", "constant", "cosine"])
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--max_seq_length", type=int, default=35)
    parser.add_argument("--max_tag_length", type=int, default=20)
    parser.add_argument("--max_img_seq_length", type=int, default=50)
    parser.add_argument("--max_phrases", type=int, default=5)
    parser.add_argument("--img_feature_dim", type=int, default=2054)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--log_period", type=int, default=10)
    parser.add_argument("--ckpt_period", type=int, default=200)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="loader worker processes (at least 1, at most "
                             "the host's CPU count)")
    parser.add_argument("--worker_start_method", type=str, default="fork",
                        choices=["fork", "spawn", "forkserver"],
                        help="how the loader starts its workers: fork shares "
                             "the dataset without pickling it; spawn starts "
                             "them clean (a parent with threads that must "
                             "not be forked)")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model for smoke tests")
    parser.add_argument("--platform", type=str, default=None,
                        choices=["cpu", "cuda"],
                        help="cpu runs the plain PyTorch path; otherwise the "
                             "driver runs on the card and raises without one")
    parser.add_argument("--hidden_dropout_prob", type=float, default=None)
    parser.add_argument("--attention_dropout_prob", type=float, default=None)
    parser.add_argument("--use_img_layernorm", type=int, default=None,
                        choices=[0, 1])
    parser.add_argument("--img_layer_norm_eps", type=float, default=None)
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="tensor-parallel degree (ranks = data x "
                             "model_parallel x pipeline_parallel)")
    parser.add_argument("--sequence_parallel", action="store_true",
                        help="also cut the LayerNorm/dropout/residual regions "
                             "along the sequence over the model ranks")
    parser.add_argument("--pipeline_parallel", type=int, default=1,
                        help="GPipe stages over the pipe ranks (the model "
                             "config takes pipeline_stages = N)")
    parser.add_argument("--pipeline_microbatches", type=int, default=4)
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the parameters over the data ranks too "
                             "(ZeRO-3 / FSDP; the moments always are)")
    parser.add_argument("--async_ckpt", action="store_true",
                        help="write checkpoints on a background thread "
                             "while training goes on (one process only; a "
                             "save under a process group stays synchronous)")
    parser.add_argument("--no_preempt_save", action="store_true",
                        help="no preemption checkpoint (by default a SIGTERM "
                             "saves a checkpoint at the next step boundary "
                             "and exits 0; under a process group every rank "
                             "saves at the same step)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace (TensorBoard / "
                             "Perfetto) of --profile_steps training steps "
                             "from step --profile_start into this dir")
    parser.add_argument("--profile_start", type=int, default=2,
                        help="first step traced (0-based; 2 skips the "
                             "warm-up steps)")
    parser.add_argument("--profile_steps", type=int, default=3,
                        help="steps in the trace window")


def check_args(args, later_items=None) -> None:
    """Raise for a flag whose port item has not landed (a driver's own
    `later_items`, and `LATER_ITEMS`, of the form flag -> (off value,
    item))."""
    for flag, (off, item) in {**LATER_ITEMS, **(later_items or {})}.items():
        if getattr(args, flag, off) not in (off, None):
            raise NotImplementedError(
                f"--{flag} is not ported yet: it waits for ROADMAP.md queue "
                f"1 {item}")


def run_device(args) -> torch.device:
    """The rank's device: CUDA (`cuda:{LOCAL_RANK}`) unless `--platform
    cpu`; CUDA without a card raises. Joins the process group first when
    WORLD_SIZE > 1 or a parallel flag asks for one."""
    from ..parallel.distributed import init_runtime
    return init_runtime(args)["device"]


def is_main() -> bool:
    from ..parallel.distributed import is_main_process
    return is_main_process()


def synth_root(args, **kw) -> dict:
    """Synthetic data under output_dir/synth (idempotent): rank 0 writes it,
    the other ranks read it after a barrier."""
    from ..data.synthetic import make_synthetic_root
    from ..parallel.distributed import barrier
    root = os.path.join(args.output_dir, "synth")
    paths = make_synthetic_root(root, **kw) if is_main() else None
    barrier()
    return paths if paths is not None else make_synthetic_root(root, **kw)


# train-time flags that define the tensorization/model contract: at eval
# time these must match training or features silently diverge (reference
# restore_training_settings, run_retrieval.py:885-899)
RESTORE_KEYS = ("max_seq_length", "max_tag_length", "max_img_seq_length",
                "max_phrases", "img_feature_dim", "use_b_text", "b_as_list",
                "use_img_layernorm", "img_layer_norm_eps")


def restore_training_settings(args, argv=None, extra_keys=(), logger=None):
    """Eval-time readback of the checkpoint's training_args.json.

    For an eval-only invocation pointed at a trained checkpoint, restores
    the train-time tensorization/preprocessing flags so eval features
    cannot silently mismatch training. Explicitly-passed CLI flags win;
    every restored or kept-overridden flag is logged. No-op when training
    (a fresh run may change the contract on purpose) or when the
    checkpoint has no args snapshot."""
    if getattr(args, "do_train", False) or not args.model_name_or_path:
        return args
    path = os.path.join(args.model_name_or_path, ARGS_NAME)
    if not os.path.exists(path):
        return args
    with open(path) as f:
        saved = json.load(f)
    given = list(argv) if argv is not None else sys.argv[1:]
    for k in tuple(RESTORE_KEYS) + tuple(extra_keys):
        if k not in saved or not hasattr(args, k):
            continue
        cur = getattr(args, k)
        # both argparse spellings count as explicit: "--key value" and
        # "--key=value"
        if any(a == f"--{k}" or a.startswith(f"--{k}=") for a in given):
            if logger and cur != saved[k]:
                logger.info(f"training_args: keeping explicit --{k}={cur} "
                            f"(checkpoint trained with {saved[k]})")
            continue
        if cur != saved[k]:
            if logger:
                logger.info(f"training_args: restored train-time "
                            f"{k}={saved[k]} (default was {cur})")
            setattr(args, k, saved[k])
    return args


def tensorize_cfg(args) -> TensorizeConfig:
    return TensorizeConfig(
        max_seq_length=args.max_seq_length,
        max_tag_length=args.max_tag_length,
        max_img_seq_length=args.max_img_seq_length,
        max_phrases=args.max_phrases,
        img_feature_dim=args.img_feature_dim)


def build_config(args, tokenizer, **overrides) -> ModelConfig:
    """The checkpoint's config with the explicit CLI knobs, or MVPTR-base
    (the vocabulary at least 86,051 rows: the phrase ids follow the
    wordpieces), or with `--tiny` a 64-wide test model."""
    cli = {}
    if args.hidden_dropout_prob is not None:
        cli["hidden_dropout_prob"] = args.hidden_dropout_prob
    if args.attention_dropout_prob is not None:
        cli["attention_probs_dropout_prob"] = args.attention_dropout_prob
    if args.classifier is not None:
        cli["classifier"] = args.classifier
    if args.cls_hidden_scale is not None:
        cli["cls_hidden_scale"] = args.cls_hidden_scale
    if args.use_img_layernorm is not None:
        cli["use_img_layernorm"] = bool(args.use_img_layernorm)
    if args.img_layer_norm_eps is not None:
        cli["img_layer_norm_eps"] = args.img_layer_norm_eps
    # the pipeline layout is a config property; only an explicit > 1 flag
    # sets it (a resumed pipeline checkpoint keeps its own)
    if max(1, getattr(args, "pipeline_parallel", 1)) > 1:
        cli["pipeline_stages"] = args.pipeline_parallel
    if args.model_name_or_path:
        return ModelConfig.from_pretrained(args.model_name_or_path,
                                           dtype=args.dtype,
                                           **{**cli, **overrides})
    base = dict(vocab_size=max(tokenizer.vocab_size, 86051),
                only_word_size=tokenizer.vocab_size,
                img_feature_dim=args.img_feature_dim, dtype=args.dtype)
    if args.tiny:
        base.update(hidden_size=64, num_hidden_layers=4,
                    num_attention_heads=4, intermediate_size=128,
                    vocab_size=tokenizer.vocab_size + 64,
                    max_position_embeddings=128)
    base.update(cli)
    base.update(overrides)
    return ModelConfig(**base)


def load_params_or_init(args, model, logger=None):
    """Load `pytorch_model.bin` (a reference state dict) from
    `--model_name_or_path` if it has one, strictly; otherwise keep the
    weights the model was seeded with."""
    if args.model_name_or_path:
        path = os.path.join(args.model_name_or_path, WEIGHTS_NAME)
        if os.path.exists(path):
            model.load_state_dict(torch.load(path, map_location=model.device,
                                             weights_only=True), strict=True)
            if logger:
                logger.info(f"loaded {path}")
    return model


class TaskFetch:
    """A task dataset's `fetch` under the model's array names (the data
    plane's names in `input_names`, by default the single pair's seven) plus
    `label`, and nothing else (no `question_id`, `det_label` or `iou_mat` in
    a training batch); `fetch(indices, epoch)` when the dataset's fetch takes
    an epoch, as `VEDataset`'s masking does (picklable, for spawned loader
    workers)."""

    def __init__(self, dataset, input_names: Mapping[str, str] = INPUT_NAMES):
        self.dataset = dataset
        self.input_names = dict(input_names)

    def __call__(self, indices, epoch: int = 0) -> Dict[str, np.ndarray]:
        batch = _epoch_aware(self.dataset.fetch)(indices, epoch)
        out = {v: batch[k] for k, v in self.input_names.items()}
        out["label"] = batch["label"]
        return out


@torch.no_grad()
def predict(model, dataset, batch_size: int, forward: Callable,
            keep: Sequence[str] = (),
            input_names: Mapping[str, str] = INPUT_NAMES
            ) -> Tuple[np.ndarray, Dict]:
    """`forward(model, *inputs)` over the whole dataset in chunks of
    `batch_size`, under `model.eval()` and `torch.no_grad()`, on this
    process; the inputs are the dataset's arrays named in `input_names`, in
    its order. The last chunk is padded by repeating its last index (the JAX
    package's fixed eval shapes) and the padding's rows are dropped. Returns
    the outputs as fp32 numpy and the dataset's arrays named in `keep`."""
    from ..parallel.collectives import (gather_eval_arrays,
                                        process_shard_indices)
    model.eval()
    n = len(dataset)
    # this data rank's examples (all of them on one rank), wrap-padded so
    # that every rank runs as many batches
    mine = process_shard_indices(n)
    outs, kept = [], {k: [] for k in keep}
    for i in range(0, len(mine), batch_size):
        chunk = mine[i:i + batch_size]
        m = len(chunk)
        if m < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:],
                                                     batch_size - m)])
        batch = dataset.fetch(chunk)
        x = batch_on(model.device, {v: batch[k]
                                    for k, v in input_names.items()})
        outs.append(forward(model, *x.values())[:m].float().cpu().numpy())
        for k in keep:
            kept[k].append(batch[k][:m])
    got = gather_eval_arrays(n, np.concatenate(outs),
                             *(np.concatenate(kept[k]) for k in keep))
    return got[0], dict(zip(keep, got[1:]))


def adjust_dropout(model, step: int, adjust_dp_step: Optional[int]) -> None:
    """`--adjust_dp_step`: every hidden dropout of `model`
    (`layers.hidden_dropouts`) at ADJUSTED_DROPOUT from step
    `adjust_dp_step` on and at the config's rate before it (the JAX
    drivers' cond between two models). The attention-probability dropout,
    which the kernel applies, keeps its rate. Without the flag, nothing."""
    if adjust_dp_step is None:
        return
    p = (ADJUSTED_DROPOUT if step >= adjust_dp_step
         else model.config.hidden_dropout_prob)
    for m in hidden_dropouts(model):
        m.p = p


class TrainLoop:
    """Sampler + process loader + trainer + checkpoint/resume + metrics.

    `fetch(indices)` returns a batch of numpy arrays under the names
    `loss_fn` reads; `num_examples` is the dataset's length. The parameters
    under `freeze_prefix` take no update for the first `freeze_steps`
    steps."""

    def __init__(self, args, model, loss_fn, fetch: Callable,
                 num_examples: int, logger,
                 freeze_prefix: Optional[str] = None, freeze_steps: int = 0):
        self.freeze_prefix = freeze_prefix
        self.freeze_steps = freeze_steps
        self.args = args
        self.model = model
        self.loss_fn = loss_fn
        self.fetch = fetch
        self.num_examples = num_examples
        self.logger = logger
        self.loader: Optional[ProcessLoader] = None
        self.mesh = None
        mp = max(1, args.model_parallel)
        pp = max(1, args.pipeline_parallel)
        import torch.distributed as dist
        if dist.is_initialized():
            from ..parallel.mesh import apply_tensor_parallel, make_mesh
            self.mesh = make_mesh(model=mp, pipe=pp)
            cfg = model.config
            if pp > 1:
                mb = max(1, args.pipeline_microbatches)
                if args.train_batch_size % (mb * self.mesh.data_size):
                    raise ValueError(
                        f"--train_batch_size {args.train_batch_size} is not "
                        f"divisible by --pipeline_microbatches {mb} x data "
                        f"ranks {self.mesh.data_size}")
                if cfg.pipeline_stages != pp:
                    raise ValueError(
                        f"--pipeline_parallel {pp} needs a model config with "
                        f"pipeline_stages={pp} (got {cfg.pipeline_stages})")
            if mp > 1 or args.sequence_parallel:
                apply_tensor_parallel(model, self.mesh,
                                      args.sequence_parallel)
            logger.info(f"mesh {self.mesh}")
        elif mp > 1 or pp > 1:
            raise ValueError("--model_parallel / --pipeline_parallel need a "
                             "process group (run under tools/launch.py)")
        if args.num_train_epochs:
            spe = max(1, -(-num_examples // args.train_batch_size))
            args.max_steps = int(spe * args.num_train_epochs)
            logger.info(f"num_train_epochs={args.num_train_epochs}: {spe} "
                        f"steps/epoch -> max_steps={args.max_steps}")

    def _batches(self, start_step: int) -> ProcessLoader:
        args = self.args
        from ..parallel.mesh import data_shard_info
        rank, world = data_shard_info(self.mesh)
        sampler = BatchSampler(self.num_examples, args.train_batch_size,
                               seed=args.seed, rank=rank, world_size=world)
        self.loader = ProcessLoader(
            self.fetch, sampler, start_step=start_step,
            num_workers=max(1, min(args.num_workers, os.cpu_count() or 1)),
            device=self.model.device,
            multiprocessing_context=args.worker_start_method)
        return self.loader

    def run(self, eval_hook: Optional[Callable[[int], Optional[Dict]]] = None):
        """Train to `--max_steps`; at each checkpoint run `eval_hook(step)`
        and append its result to eval_logs.json. Returns each step's
        metrics. A SIGTERM (unless `--no_preempt_save`) saves a checkpoint
        at the next step boundary and raises `SystemExit(0)`, before any
        eval."""
        args = self.args

        def on_checkpoint(step):
            if eval_hook is None:
                return
            res = eval_hook(step)
            if res and is_main():
                # the reference's console marker (run_pretrain_ml.py:698-
                # 701): 100 (1 - the first accuracy-like metric)
                for k, v in res.items():
                    if "acc" in k and np.isscalar(v):
                        self.logger.info(f"EVALERR: {100.0 * (1 - v):.2f}%")
                        break
                path = os.path.join(args.output_dir, "eval_logs.json")
                logs = []
                if os.path.exists(path):
                    with open(path) as f:
                        logs = json.load(f)
                logs.append({"step": step, **res})
                with open(path, "w") as f:
                    json.dump(logs, f, indent=2)

        return run_training(
            self.model, self.loss_fn, self._batches, args.max_steps,
            learning_rate=args.learning_rate,
            warmup_steps=args.warmup_steps, schedule=args.scheduler,
            weight_decay=args.weight_decay, eps=args.adam_epsilon,
            max_grad_norm=args.max_grad_norm,
            grad_accum=args.gradient_accumulation_steps, seed=args.seed,
            output_dir=args.output_dir,
            metrics_dir=os.path.join(args.output_dir, "train_logs"),
            ckpt_period=args.ckpt_period, log_period=args.log_period,
            logger=self.logger.info, saved_args=vars(args),
            on_checkpoint=on_checkpoint,
            timing=lambda: self.loader.timing(),
            freeze_prefix=self.freeze_prefix, freeze_steps=self.freeze_steps,
            mesh=self.mesh, fsdp=args.fsdp,
            pipeline_microbatches=args.pipeline_microbatches,
            batch_size=args.train_batch_size, async_ckpt=args.async_ckpt,
            preempt_save=not args.no_preempt_save,
            profile_dir=args.profile_dir, profile_start=args.profile_start,
            profile_steps=args.profile_steps)
