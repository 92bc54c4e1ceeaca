"""The single-stream backbone and its heads, the JAX package's
`models/img_bert.py` (:37-247):

- `ImgBertModel` (reference BertImgModel, `oscar/modeling/
  modeling_vlbert.py:202-352`): one `num_hidden_layers`-deep BERT over
  `[text ; projected regions]`. The attention mask is `[B, L]`, `[B, L, L]`
  (seq2seq or stage masks) or a list of per-layer masks (the reference's
  "stage attention", :140-156, 265-276); L covers text and regions. The
  `dis_code` / `dis_code_t` variants embed discrete image codes instead of
  continuous features (:219-228, 315-325);
- `ImgBertForPreTraining` (`modeling_vlbert_pretrain.py:1920-2028`, and
  VLBertImgForPreTraining, :2107-2223): MLM over the text positions, ITM
  over the pooled output and, with `use_mrfr`, masked-region tag
  classification (MRC) and feature regression (MRF, tied to the region
  projection);
- `ImgBertForSequenceClassification` (`modeling_vlbert.py:886-967`) and
  `ImgBertForMultipleChoice` (`modeling_vlbert_pretrain.py:1319-1499`);
- `CaptioningModel` (BertForImageCaptioning, `modeling_vlbert_pretrain.py:
  1565-1875`; the JAX package's :250-430): masked caption positions trained
  with a label-smoothed KL and the drop-worst curriculum under a seq2seq mask
  (caption causal, context bidirectional and blind to the caption), and the
  two decoding forwards: the full-prefix recompute (`decode_logits`) and the
  history-cached step (`prefill`, then `decode_step`).

Every attention layer runs on `masked_attention`, so on the card each layer
launches the hand-written kernel; a 3-D or per-layer mask reaches it as a
`[B, 1, L, L]` bias. Each model takes `(config, *, device, seed)`, is seeded,
moved to `device` and left in eval mode; dropout follows the module's
training mode and draws from the `generator` a forward is given. Parameter
names are the reference's state-dict keys (`bert.encoder.layer.N.*`,
`bert.img_embedding.*`, `bert.LayerNorm.*` for the region LayerNorm,
`bert.code_embeddings.weight`, `cls.*`, `classifier.*`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..ops.masked import (gather_masked_positions, masked_ce_terms,
                          masked_cross_entropy)
from ..parallel.collectives import LOCAL, GlobalBatch
from .config import ModelConfig
from .heads import (ClassifierHead, LMPredictionHead, MRFMRCHeads,
                    SeqRelationshipHead)
from .layers import (Dense, Dropout, Embeddings, LayerNorm, Pooler,
                     StreamEncoder, compute_dtype, dropout_generator,
                     init_weights, mask_to_bias, resolve_device)
from .pretrain import PretrainingHeads, drop_tied_decoders
from .tasks import classification_loss, instance_bce_with_logits

__all__ = ["ImgBertModel", "ImgBertForPreTraining",
           "ImgBertForSequenceClassification", "ImgBertForMultipleChoice",
           "CaptioningModel", "make_seq2seq_mask", "captioning_loss"]


class ImgBertModel(nn.Module):
    """BERT over [text ; projected regions], full depth.

    `code_voc` / `code_dim`: the discrete-code table of the `dis_code*`
    feature types; `code_size` is the number of codes an image has, the
    region projection's input width under `dis_code_t` (codes and their
    dimensions swapped)."""

    def __init__(self, config: ModelConfig, *, code_voc: int = 0,
                 code_dim: int = 0, code_size: int = 0):
        super().__init__()
        dt = compute_dtype(config)
        h = config.hidden_size
        self.config = config
        feature_type = config.img_feature_type
        self.embeddings = Embeddings(config)
        self.encoder = StreamEncoder(config, config.num_hidden_layers)
        self.pooler = Pooler(config)
        img_in = config.img_feature_dim
        if feature_type.startswith("dis_code"):
            self.code_embeddings = nn.Embedding(code_voc, code_dim)
            img_in = code_size if feature_type == "dis_code_t" else code_dim
        self.img_embedding = Dense(img_in, h, dt)
        if config.use_img_layernorm:
            self.LayerNorm = LayerNorm(h, config.img_layer_norm_eps, dt)
        self.img_dropout = Dropout(config.hidden_dropout_prob)

    def word_table(self) -> torch.Tensor:
        return self.embeddings.word_table()

    def img_kernel(self) -> torch.Tensor:
        """The region projection's [H, img_dim] weight, for the tied MRF
        head."""
        return self.img_embedding.weight

    def embed_image(self, img_feats):
        """Image features -> [B, N, H]: the projection of continuous features
        (then the region LayerNorm and dropout), or of the code embeddings
        of `dis_code*` codes (no dropout: it applies to continuous features
        only)."""
        feature_type = self.config.img_feature_type
        if feature_type.startswith("dis_code"):
            code = nn.functional.embedding(
                img_feats, self.code_embeddings.weight).to(
                    compute_dtype(self.config))
            if feature_type == "dis_code_t":
                code = code.transpose(1, 2)
            return self.img_embedding(code)
        img = self.img_embedding(img_feats)
        if self.config.use_img_layernorm:
            img = self.LayerNorm(img)
        return self.img_dropout(img)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, img_feats=None):
        """-> (sequence [B, L, H], pooled [B, H]). `attention_mask`: [B, L],
        [B, L, L] or a list of one such mask per layer; None attends to
        everything."""
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        if img_feats is not None:
            emb = torch.cat([emb, self.embed_image(img_feats).to(emb.dtype)],
                            dim=1)
        if attention_mask is None:
            attention_mask = torch.ones(emb.shape[:2], dtype=torch.int32,
                                        device=emb.device)
        if isinstance(attention_mask, (list, tuple)):
            bias = [mask_to_bias(m) for m in attention_mask]
        else:
            bias = mask_to_bias(attention_mask)
        seq, _ = self.encoder(emb, bias)
        return seq, self.pooler(seq)


class _ImgBertBase(nn.Module):
    """`bert` (an `ImgBertModel`), the heads a subclass builds in
    `build_heads`; seeded with the JAX package's init (normal
    (initializer_range) kernels and tables, zero biases, unit LayerNorm
    scales), moved to `device`, in eval mode."""

    def __init__(self, config: ModelConfig, *, device="cuda", seed: int = 0,
                 **bert_kw):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = ImgBertModel(config, **bert_kw)
        self.build_heads(config)
        generator = torch.Generator().manual_seed(seed)
        init_weights(self, config.initializer_range, generator)
        for m in self.modules():
            if isinstance(m, ClassifierHead):
                m.init_weights(config.initializer_range, generator)
        self.to(device)
        self.eval()

    def build_heads(self, config: ModelConfig) -> None:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.bert.img_embedding.weight.device


class _MRFPretrainingHeads(MRFMRCHeads):
    """The reference's `cls` of VLBertImgForPreTraining: the masked-region
    heads beside the text MLM head and the ITM head."""

    def __init__(self, config: ModelConfig, od_tag_size: int):
        super().__init__(config, od_tag_size)
        self.predictions = LMPredictionHead(config)
        self.seq_relationship = SeqRelationshipHead(config)


class ImgBertForPreTraining(_ImgBertBase):
    """Single-stream pretraining: MLM + ITM, and with `use_mrfr` MRC + MRF.

    Keys: `bert.*`, `cls.predictions.*` (the MLM head, tied to the first
    `only_word_size` rows of the word table: a reference state dict's
    `cls.predictions.decoder.weight` is checked against them and dropped on
    load), `cls.seq_relationship.*` and with `use_mrfr` `cls.MRF_predictor.*`,
    `cls.MRC_predictor.*`, `cls.MRF_bias`."""

    TIED_DECODERS = ("cls.predictions.decoder.weight",)

    def __init__(self, config: ModelConfig, *, use_mrfr: bool = False,
                 od_tag_size: int = 1601, device="cuda", seed: int = 0,
                 **bert_kw):
        self.use_mrfr = use_mrfr
        self.od_tag_size = od_tag_size
        super().__init__(config, device=device, seed=seed, **bert_kw)

    def build_heads(self, config):
        self.cls = (_MRFPretrainingHeads(config, self.od_tag_size)
                    if self.use_mrfr else PretrainingHeads(config))

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor],
                        strict: bool = True, assign: bool = False):
        state_dict = drop_tied_decoders(state_dict, self.TIED_DECODERS,
                                        self.config.only_word_size)
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def forward(self, input_ids, attention_mask, token_type_ids, img_feats,
                masked_lm_labels, next_sentence_label=None,
                masked_region_labels=None, masked_region_targets=None,
                masked_region_flags=None, *, max_pred: int = 20,
                generator: Optional[torch.Generator] = None,
                global_batch: GlobalBatch = LOCAL
                ) -> Dict[str, torch.Tensor]:
        """The JAX `ImgBertForPreTraining.__call__`: `mlm_loss` over at most
        `max_pred` labelled text positions (`masked_lm_labels` spans the
        text ids, -1 = unlabelled); with `next_sentence_label`, `itm_loss`
        (-1 rows count for nothing); with `use_mrfr` and
        `masked_region_labels`, `mrc_loss` (CE over regions labelled >= 0)
        and `mrf_loss` (the squared error to `masked_region_targets` over
        the regions `masked_region_flags` marks, or the labelled ones
        without flags, over max(sum of weights x img_dim, 1)); and
        `total_loss`, their sum. The MLM, ITM and MRC means are over
        `global_batch`'s count."""
        gb = global_batch
        with dropout_generator(self, generator):
            seq, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                                    img_feats=img_feats)
        la = input_ids.shape[1]
        table = self.bert.word_table()
        mh, ml, mw = gather_masked_positions(seq[:, :la], masked_lm_labels,
                                             max_pred)
        mlm_loss = gb.mean(*masked_ce_terms(self.cls.predictions(mh, table),
                                            ml, mw))
        out = {"mlm_loss": mlm_loss}
        total = mlm_loss
        if next_sentence_label is not None:
            itm_logits = self.cls.seq_relationship(pooled)
            itm_loss = gb.mean(*masked_ce_terms(
                itm_logits, next_sentence_label.clamp(min=0),
                (next_sentence_label >= 0).float()))
            total = total + itm_loss
            out["itm_loss"] = itm_loss
        if self.use_mrfr and masked_region_labels is not None:
            if masked_region_targets is None:
                raise ValueError(
                    "use_mrfr with masked_region_labels requires "
                    "masked_region_targets (the unmasked region features "
                    "the MRF head regresses on)")
            mrf, mrc = self.cls.mrf_mrc(seq[:, la:], self.bert.img_kernel())
            w = (masked_region_labels >= 0).float()
            mrc_loss = gb.mean(*masked_ce_terms(mrc, masked_region_labels,
                                                w))
            w_mrf = (masked_region_flags.float()
                     if masked_region_flags is not None else w)
            sq = (mrf - masked_region_targets.float()) ** 2
            mrf_loss = (w_mrf[..., None] * sq).sum() / torch.clamp(
                w_mrf.sum() * mrf.shape[-1], min=1.0)
            total = total + mrc_loss + mrf_loss
            out.update(mrc_loss=mrc_loss, mrf_loss=mrf_loss)
        out["total_loss"] = total
        return out


class ImgBertForSequenceClassification(_ImgBertBase):
    """Pooled output -> dropout -> `ClassifierHead`; the loss by
    `config.loss_type` (`models/tasks.py` `classification_loss`). Keys:
    `bert.*`, `classifier.*`."""

    def build_heads(self, config):
        self.classifier = ClassifierHead(config)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, attention_mask, token_type_ids, img_feats,
                labels=None, *, generator: Optional[torch.Generator] = None):
        """Logits [B, num_labels], or (loss, logits) with `labels`."""
        with dropout_generator(self, generator):
            _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                                  img_feats=img_feats)
            logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return classification_loss(self.config, logits, labels), logits


class ImgBertForMultipleChoice(_ImgBertBase):
    """VCR-style multiple choice: the choice axis is flattened into the
    batch, each (question, choice, image) encoded single-stream, and the
    choices' pooled outputs side by side ([B, num_choice x H]) go through
    one classifier. `loss_type` 'bce' takes VQA's instance BCE, any other CE
    (reference :1386-1392). Keys: `bert.*`, `classifier.*`."""

    def __init__(self, config: ModelConfig, *, num_choice: int = 4,
                 device="cuda", seed: int = 0, **bert_kw):
        self.num_choice = num_choice
        super().__init__(config, device=device, seed=seed, **bert_kw)

    def build_heads(self, config):
        self.classifier = ClassifierHead(
            config, in_features=self.num_choice * config.hidden_size)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, attention_mask, token_type_ids, img_feats,
                labels=None, *, generator: Optional[torch.Generator] = None):
        """input_ids [B, C, L], masks [B, C, L(, L)], img_feats [B, C, R, D]
        or None -> logits [B, num_labels], or (loss, logits) with
        `labels`."""
        b, c = input_ids.shape[:2]
        if c != self.num_choice:
            raise ValueError(f"{c} choices, the model takes "
                             f"{self.num_choice}")

        def flat(x):
            return x.reshape((b * c,) + tuple(x.shape[2:]))

        with dropout_generator(self, generator):
            _, pooled = self.bert(
                flat(input_ids), flat(attention_mask), flat(token_type_ids),
                img_feats=flat(img_feats) if img_feats is not None else None)
            logits = self.classifier(
                self.dropout(pooled).reshape(b, c * pooled.shape[-1]))
        if labels is None:
            return logits
        if self.config.loss_type == "bce":
            loss = instance_bce_with_logits(logits, labels)
        else:
            loss = masked_cross_entropy(
                logits, labels, torch.ones(b, device=logits.device))
        return loss, logits


# ---------------------------------------------------------------------------
# captioning
# ---------------------------------------------------------------------------

def make_seq2seq_mask(l_cap: int, ctx_mask: torch.Tensor) -> torch.Tensor:
    """[B, L, L] int32 mask over [caption ; context] (L = l_cap + the
    context's length): the caption causal and seeing the valid context; the
    context bidirectional over itself and blind to the caption (the
    reference's seq2seq mask, modeling_vlbert_pretrain.py:1620-1875)."""
    b, l_ctx = ctx_mask.shape
    dev = ctx_mask.device
    ctx = ctx_mask.to(torch.int32)[:, None, :]
    causal = torch.tril(torch.ones(l_cap, l_cap, dtype=torch.int32,
                                   device=dev))
    cap_rows = torch.cat([causal.expand(b, l_cap, l_cap),
                          ctx.expand(b, l_cap, l_ctx)], dim=2)
    ctx_rows = torch.cat([torch.zeros(b, l_ctx, l_cap, dtype=torch.int32,
                                      device=dev),
                          ctx.expand(b, l_ctx, l_ctx)], dim=2)
    return torch.cat([cap_rows, ctx_rows], dim=1)


def captioning_loss(logits, targets, weights, *, label_smoothing: float = 0.1,
                    drop_worst_ratio: float = 0.0, apply_drop=None):
    """Label-smoothed KL over the masked caption positions (`weights` > 0),
    with the drop-worst curriculum (reference BertCaptioningLoss
    :1537-1563).

    Drop-worst keeps the smallest floor(n_masked (1 - ratio)) of the masked
    positions' losses (at least one), ranked by a stable double argsort with
    the unmasked positions at +inf, as `jnp.argsort` ranks them (stable: tied
    losses keep their order). `apply_drop` (a bool) gates the curriculum:
    the reference's drop_worst_after step threshold."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    eps = label_smoothing
    tgt = targets.long().clamp(0, v - 1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    smooth = -logp.sum(dim=-1)
    # KL(smoothed one-hot || p) up to the target's constant entropy
    per = (1.0 - eps) * nll + (eps / (v - 1)) * (smooth - nll)
    per = per * weights
    flat = per.reshape(-1)
    wflat = weights.reshape(-1).float()
    plain = flat.sum() / wflat.sum().clamp(min=1.0)
    if drop_worst_ratio <= 0:
        return plain
    keep_count = torch.floor(wflat.sum() * (1.0 - drop_worst_ratio)).clamp(
        min=1.0)
    cand = torch.where(wflat > 0, flat, torch.full_like(flat, float("inf")))
    ranks = torch.argsort(torch.argsort(cand, stable=True), stable=True)
    keep = (ranks < keep_count) & (wflat > 0)
    dropped = (torch.where(keep, flat, torch.zeros_like(flat)).sum()
               / keep.sum().clamp(min=1))
    if apply_drop is None:
        return dropped
    return dropped if apply_drop else plain


class _CaptioningHeads(nn.Module):
    """The reference's `cls` of BertForImageCaptioning: the LM head over the
    whole vocabulary."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.predictions = LMPredictionHead(config, only_vocab=False)


class CaptioningModel(_ImgBertBase):
    """Image captioning over the single-stream backbone.

    Keys: `bert.*` and `cls.predictions.*` (tied to the whole word table:
    a reference state dict's `cls.predictions.decoder.weight`, a copy of
    the table, is checked against it and dropped on load). The caption's
    segment id is 0 and the context's 1, as the drivers give them."""

    TIED_DECODERS = ("cls.predictions.decoder.weight",)

    def __init__(self, config: ModelConfig, *, label_smoothing: float = 0.1,
                 drop_worst_ratio: float = 0.0, drop_worst_after: int = 0,
                 device="cuda", seed: int = 0, **bert_kw):
        self.label_smoothing = label_smoothing
        self.drop_worst_ratio = drop_worst_ratio
        self.drop_worst_after = drop_worst_after
        super().__init__(config, device=device, seed=seed, **bert_kw)

    def build_heads(self, config):
        self.cls = _CaptioningHeads(config)

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor],
                        strict: bool = True, assign: bool = False):
        state_dict = drop_tied_decoders(state_dict, self.TIED_DECODERS,
                                        self.config.vocab_size)
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def _encode(self, input_ids, ctx_ids, ctx_mask, token_type_ids,
                ctx_token_type_ids, img_feats):
        """The sequence output over [caption ; tags ; regions] under the
        seq2seq mask."""
        l_cap = input_ids.shape[1]
        seq, _ = self.bert(
            torch.cat([input_ids, ctx_ids], dim=1),
            make_seq2seq_mask(l_cap, ctx_mask),
            torch.cat([token_type_ids, ctx_token_type_ids], dim=1),
            img_feats=img_feats)
        return seq

    def forward(self, input_ids, ctx_ids, ctx_mask, token_type_ids,
                ctx_token_type_ids, img_feats, masked_pos=None,
                masked_ids=None, step=None, *,
                generator: Optional[torch.Generator] = None):
        """input_ids: the caption [B, L_cap] with its [MASK]s; ctx_ids: the
        tags; ctx_mask covers tags and regions. Returns the logits
        [B, L_cap, vocab_size] (fp32), or with `masked_pos` ([B, L_cap] 0/1)
        and `masked_ids` (the targets, 0 where unmasked) (loss, logits).
        `step` gates drop-worst by `drop_worst_after`."""
        l_cap = input_ids.shape[1]
        with dropout_generator(self, generator):
            seq = self._encode(input_ids, ctx_ids, ctx_mask, token_type_ids,
                               ctx_token_type_ids, img_feats)
        logits = self.cls.predictions(seq[:, :l_cap], self.bert.word_table())
        if masked_pos is None:
            return logits
        apply_drop = None
        if self.drop_worst_after > 0 and step is not None:
            apply_drop = step >= self.drop_worst_after
        loss = captioning_loss(logits, masked_ids, masked_pos.float(),
                               label_smoothing=self.label_smoothing,
                               drop_worst_ratio=self.drop_worst_ratio,
                               apply_drop=apply_drop)
        return loss, logits

    def decode_logits(self, caption_ids, ctx_ids, ctx_mask, token_type_ids,
                      ctx_token_type_ids, img_feats, t: int):
        """The recompute path's forward: the whole caption buffer under the
        causal mask, the LM head at position `t` only -> [N, vocab_size]
        (the position the decoding loop reads; the JAX package's
        `decode_logits` returns every position's). `t` is an int, or a
        tensor [N] of each row's own position (SCST's masked copies)."""
        seq = self._encode(caption_ids, ctx_ids, ctx_mask, token_type_ids,
                           ctx_token_type_ids, img_feats)
        if isinstance(t, torch.Tensor):
            hidden = seq[torch.arange(seq.shape[0], device=seq.device), t]
        else:
            hidden = seq[:, t]
        return self.cls.predictions(hidden, self.bert.word_table())

    # -- history-cached decoding (the reference's past reuse,
    #    modeling_utils.py:21-598; the cache holds each layer's INPUT states
    #    like the reference's history_states, modeling_vlbert.py:63-69) ----

    def prefill(self, ctx_ids, ctx_mask, ctx_token_type_ids, img_feats,
                l_cap: int) -> torch.Tensor:
        """Encode the context once. Returns the history cache
        [layers, N, l_cap + L_ctx, H] in the compute dtype: the caption
        slots 0..l_cap-1 zero (filled step by step), the context slots each
        layer's input states. The context keeps its training positions
        (l_cap + i, after the caption block) and sees only itself, so its
        states are exact and never change."""
        cfg = self.config
        pos = l_cap + torch.arange(ctx_ids.shape[1],
                                   device=ctx_ids.device)[None, :]
        emb = self.bert.embeddings(ctx_ids, ctx_token_type_ids, pos)
        emb = torch.cat([emb, self.bert.embed_image(img_feats).to(emb.dtype)],
                        dim=1)
        _, _, states = self.bert.encoder(emb, mask_to_bias(ctx_mask),
                                         collect_states=True)
        n, l_ctx = emb.shape[:2]
        cache = emb.new_zeros(cfg.num_hidden_layers, n, l_cap + l_ctx,
                              cfg.hidden_size)
        cache[:, :, l_cap:] = torch.stack(states)
        return cache

    def decode_step(self, cache, t: int, prev_token, ctx_mask, l_cap: int,
                    mask_token_id: int, cap_type_id: int = 0):
        """One cached step at position `t`: runs [the committed token t - 1,
        [MASK] at t] against the cache, writes t - 1's layer input states
        into cache slot t - 1 in place, and returns (logits [N, vocab_size]
        at t, cache). Keys: the caption slots before t - 1 and the valid
        context; of the two fresh positions the committed token is visible
        to both queries, the [MASK] only to itself. `cap_type_id` is the
        caption's segment id of training (0 in the drivers)."""
        n = prev_token.shape[0]
        dev = prev_token.device
        # the step's constants are made on the device: copying a host
        # tensor there would wait for the queued work at every step
        ids = torch.stack([prev_token,
                           torch.full_like(prev_token, mask_token_id)], dim=1)
        pos = (torch.arange(2, device=dev) + (t - 1))[None].expand(n, 2)
        emb = self.bert.embeddings(ids, torch.full_like(ids, cap_type_id),
                                   pos)
        l_total = cache.shape[2]
        cap_valid = torch.arange(l_cap, device=dev)[None, :] < (t - 1)
        key_valid = torch.cat([cap_valid.expand(n, l_cap),
                               ctx_mask.bool()], dim=1).to(torch.int32)
        fresh = torch.ones(2, 2, dtype=torch.int32, device=dev).tril()
        full_valid = torch.cat([key_valid[:, None, :].expand(n, 2, l_total),
                                fresh[None].expand(n, 2, 2)], dim=2)
        seq, _, states = self.bert.encoder(emb, mask_to_bias(full_valid),
                                           history_states=cache,
                                           collect_states=True)
        cache[:, :, t - 1] = torch.stack(states)[:, :, 0]
        logits = self.cls.predictions(seq[:, 1], self.bert.word_table())
        return logits, cache
