"""Plain PyTorch building blocks of the benchmark's reference models.

The reference is written from the published description of BERT-style
vision-language encoders (post-LN layers, GELU feed-forward, additive
-10000 attention masks) and imports nothing of the program under test. It
works in float32 with TF32 off. `Numerics("float8")` is the control: every
matrix product takes its operands rounded to float8 e4m3 (a per-tensor
scale, as fp8 training recipes take it) and accumulates in float32.

`Stream` draws a training step's random choices in the order and with the
calls that the program's documented random stream makes them (a step's
generator seeded from (seed, step, micro batch); hidden-dropout masks by
`bernoulli_` on a tensor of the compute type; one int64 seed a call for the
attention-probability mask, which is a counter hash of that seed and each
probability's flat index), so that both sides drop the same elements and a
step is one function to compare.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

MASK_VALUE = -10000.0
_M32 = 0xFFFFFFFF
E4M3_MAX = 448.0


def no_tf32() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Numerics:
    """How the reference multiplies: "float32", or the control's "float8"."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return x
        scale = E4M3_MAX / x.detach().abs().amax().clamp(min=1e-30)
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x.detach())      # straight through in the backward

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def linear(self, x, w, b=None):
        y = self.mm(x, w.t())
        return y if b is None else y + b


def step_seed(seed: int, step: int, micro: int = 0) -> int:
    """The seed of a training step's generator: the first 64-bit word that
    numpy's SeedSequence gives for (seed, step, micro), shifted right once."""
    ss = np.random.SeedSequence([seed, step, micro])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _mul32(x, c: int):
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_keep(seed: torch.Tensor, p: float, shape) -> torch.Tensor:
    """Keep mask of [B, H, Lq, Lk] probabilities: an element is dropped when
    the 32-bit hash of (flat index, 64-bit seed) is below round(p 2^32).
    The hash: low word of the index xor the seed's low word, plus 0x9E3779B9
    times (high word xor the seed's high word), then a multiply-xorshift
    mixer."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    s = seed.reshape(())
    s0, s1 = s & _M32, (s >> 32) & _M32
    x = ((idx & _M32) ^ s0) + _mul32((idx >> 32) ^ s1, 0x9E3779B9)
    h = _mix32(x & _M32)
    return (h >= round(p * 2 ** 32)).view(shape)


class Stream:
    """One training step's random draws (see the module docstring). With
    `generator` None the step has no dropout and no random choice may be
    drawn."""

    def __init__(self, generator: Optional[torch.Generator], p_hidden: float,
                 p_attn: float, mask_dtype: torch.dtype):
        self.g = generator
        self.p_hidden = p_hidden if generator is not None else 0.0
        self.p_attn = p_attn if generator is not None else 0.0
        self.mask_dtype = mask_dtype

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p_hidden
        if p == 0:
            return x
        keep = torch.empty(x.shape, dtype=self.mask_dtype,
                           device=x.device).bernoulli_(1.0 - p,
                                                       generator=self.g)
        return x * keep.float() / (1.0 - p)

    def attn(self, probs: torch.Tensor) -> torch.Tensor:
        p = self.p_attn
        if p == 0:
            return probs
        seed = torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device=probs.device, generator=self.g)
        keep = hash_keep(seed, p, probs.shape)
        return probs * keep.float() * (1.0 / (1.0 - p))

    def randperm(self, n: int, device) -> torch.Tensor:
        return torch.randperm(n, generator=self.g, device=device)

    def randint(self, low: int, high: int, n: int, device) -> torch.Tensor:
        return torch.randint(low, high, (n,), generator=self.g, device=device)

    def multinomial(self, w: torch.Tensor) -> torch.Tensor:
        return torch.multinomial(w, 1, generator=self.g)[:, 0]


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] 0/1 mask -> [B, 1, 1, L] additive float32 bias."""
    return (1.0 - mask[:, None, None, :].float()) * MASK_VALUE


def gelu(x):
    return F.gelu(x)     # the exact erf form, as BERT publishes it


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


class Blocks:
    """The layers over a weight dict `W` (float32 tensors under the
    published state-dict keys) and a config dict."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict,
                 num: Numerics):
        self.W, self.cfg, self.num = W, cfg, num
        self.eps = cfg["layer_norm_eps"]

    def dense(self, x, pre):
        return self.num.linear(x, self.W[pre + ".weight"],
                               self.W.get(pre + ".bias"))

    def ln(self, x, pre, eps=None):
        return layer_norm(x, self.W[pre + ".weight"], self.W[pre + ".bias"],
                          self.eps if eps is None else eps)

    def embeddings(self, pre, ids, types, st: Stream):
        W = self.W
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (W[pre + ".word_embeddings.weight"][ids]
             + W[pre + ".position_embeddings.weight"][pos][None]
             + W[pre + ".token_type_embeddings.weight"][types])
        return st.hidden(self.ln(x, pre + ".LayerNorm"))

    def layer(self, pre, x, bias, st: Stream):
        cfg, num = self.cfg, self.num
        b, l, h = x.shape
        nh = cfg["num_attention_heads"]
        d = h // nh

        def heads(t):
            return t.view(b, l, nh, d).transpose(1, 2)
        q = heads(self.dense(x, pre + ".attention.self.query"))
        k = heads(self.dense(x, pre + ".attention.self.key"))
        v = heads(self.dense(x, pre + ".attention.self.value"))
        scores = num.mm(q, k.transpose(-1, -2)) / math.sqrt(d) + bias
        probs = st.attn(torch.softmax(scores, dim=-1))
        ctx = num.mm(probs, v).transpose(1, 2).reshape(b, l, h)
        a = st.hidden(self.dense(ctx, pre + ".attention.output.dense"))
        a = self.ln(a + x, pre + ".attention.output.LayerNorm")
        f = gelu(self.dense(a, pre + ".intermediate.dense"))
        f = st.hidden(self.dense(f, pre + ".output.dense"))
        return self.ln(f + a, pre + ".output.LayerNorm")

    def encoder(self, pre, n_layers, x, mask, st: Stream):
        bias = mask_bias(mask)
        for i in range(n_layers):
            x = self.layer(f"{pre}.layer.{i}", x, bias, st)
        return x

    def pooler(self, pre, seq):
        return torch.tanh(self.dense(seq[:, 0], pre + ".dense"))

    def lm_head(self, pre, h, table, n_words):
        t = self.ln(gelu(self.dense(h, pre + ".transform.dense")),
                    pre + ".transform.LayerNorm")
        return self.num.mm(t, table[:n_words].t()) + self.W[pre + ".bias"]


def gather_labelled(hidden, labels, max_pred: int):
    """The first `max_pred` labelled positions (label >= 0) of each row, in
    their order, then unlabelled ones: (hidden [B, P, H], labels [B, P])."""
    l = hidden.shape[1]
    pos = torch.arange(l, device=hidden.device)[None, :]
    order = torch.argsort(torch.where(labels >= 0, pos, pos + l),
                          dim=1)[:, :max_pred]
    h = hidden.gather(1, order[..., None].expand(-1, -1, hidden.shape[-1]))
    return h, labels.gather(1, order)


def masked_ce(logits, labels):
    """Mean cross entropy over labels in [0, V); 0 where none is."""
    v = logits.shape[-1]
    w = ((labels >= 0) & (labels < v)).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp(0, v - 1)[..., None])[..., 0]
    n = w.sum()
    return torch.where(n > 0, (nll * w).sum() / n.clamp(min=1.0),
                       torch.zeros_like(n))


def ce(logits, labels):
    return F.cross_entropy(logits.float(), labels)


def l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def param_spec_encoder_layer(pre: str, h: int, inter: int):
    """(name, shape, init) of one post-LN layer's parameters."""
    out = []
    for name, shape in (("attention.self.query", (h, h)),
                        ("attention.self.key", (h, h)),
                        ("attention.self.value", (h, h)),
                        ("attention.output.dense", (h, h)),
                        ("intermediate.dense", (inter, h)),
                        ("output.dense", (h, inter))):
        out += [(f"{pre}.{name}.weight", shape, "normal"),
                (f"{pre}.{name}.bias", shape[:1], "zeros")]
    for name in ("attention.output.LayerNorm", "output.LayerNorm"):
        out += [(f"{pre}.{name}.weight", (h,), "ones"),
                (f"{pre}.{name}.bias", (h,), "zeros")]
    return out


def param_spec_embeddings(pre: str, cfg: dict):
    h = cfg["hidden_size"]
    return [(f"{pre}.word_embeddings.weight", (cfg["vocab_size"], h),
             "normal"),
            (f"{pre}.position_embeddings.weight",
             (cfg["max_position_embeddings"], h), "normal"),
            (f"{pre}.token_type_embeddings.weight",
             (cfg["type_vocab_size"], h), "normal"),
            (f"{pre}.LayerNorm.weight", (h,), "ones"),
            (f"{pre}.LayerNorm.bias", (h,), "zeros")]


def param_spec_dense(pre: str, n_out: int, n_in: int):
    return [(f"{pre}.weight", (n_out, n_in), "normal"),
            (f"{pre}.bias", (n_out,), "zeros")]


def param_spec_lm_head(pre: str, h: int, n_words: int):
    return (param_spec_dense(pre + ".transform.dense", h, h)
            + [(pre + ".transform.LayerNorm.weight", (h,), "ones"),
               (pre + ".transform.LayerNorm.bias", (h,), "zeros"),
               (pre + ".bias", (n_words,), "zeros")])
