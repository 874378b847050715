"""BERT (mirrors ``paddle_tpu/models/bert.py``): the encoder and its
pretraining heads, the DP + AMP north-star configuration.

Parameter names and layouts equal the reference's ``state_dict()``, so
``models.gpt.load_reference_state`` loads the reference's weights and
``state_to_numpy`` hands them back. ``Linear`` weights are ``[in, out]``;
the fused qkv projection interleaves q|k|v on its output columns, and
the MLM decoder is tied to ``bert.embeddings.word.weight``.

The block is post-norm (``ln_1(x + attn)``, then ``ln_2(x + mlp)``) with
the exact (erf) GELU, as the reference calls ``F.gelu`` with no argument
(GPT's MLP uses the tanh form). Attention is bidirectional: without a
padding mask it reaches the flash kernels with ``causal=False`` (S 512
is one tile each way, so the backward is the single-tile kernel); with
``attn_mask`` (bool: True keeps, or additive) it runs the plain masked
softmax of ``nn.functional.scaled_dot_product_attention``.

Under a mesh whose ``tp`` axis is > 1 (built after
``distributed.mesh.init_mesh``) the heads split over ``tp`` as GPT's do:
the qkv shard holds q, k and v of ``num_heads / tp`` heads (cut on the
heads of its ``[3, H, D]`` columns, ``shard_views``), the out and fc
projections are row-parallel over an already-parallel input, the word
table and the tied decoder are vocab-sharded, and so is ``mlm_bias``
(``param_shardings = {"mlm_bias": P("tp")}``: ``shard_reference_state``
cuts it and ``gather_reference_state`` puts it together). Dropout in the
replicated regions draws equal masks on every rank of a ``tp`` group
(GPT's ``_ReplicatedMasks``).

The pipeline protocol (``distributed/hybrid.py``) takes the batch
``(tokens, token_type_ids, mlm_labels, nsp_labels)``; ``mlm_labels`` is
-100 at positions that are not predicted. ``pipeline_head`` runs the MLM
head through the fused tied-decoder CE (``ops/fused_ce.py``) and the NSP
head on the CLS row. With ``config.max_predictions`` it first gathers
each row's first ``max_predictions`` masked positions (a stable sort of
the 0/1 mask: ties in the lowest index first, as ``jax.lax.top_k``
breaks them), so that only those run the transform and the vocab
product; a row that masks more drops the same positions as the
reference.

The loss is two means over different counts: the masked positions and
the rows. The reference's head runs once over the global batch; a rank
of the port's trainers runs it over a micro-batch's dp slice. So the
model gives the trainers the global batch's counts
(``pipeline_loss_totals``), they open ``context.loss_totals_scope``
around each forward, and the head returns its slice's share of the
global two-term loss (each term's sum over the global count). Outside
that scope the head takes its own means (the eager ``loss``).

Under sequence parallelism (``sp`` > 1) the encoder is not cut: every sp
rank runs the whole sequence and its head returns the loss with a
gradient of 1/sp of it, so that the sum over ``sp`` the trainer takes is
the loss's gradient. The fused CE then runs in one chunk, as the
reference picks under sp.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as TF

from ..core.place import resolve_device
from ..distributed.mesh import P
from ..distributed.parallel_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding,
                                           _CopyToTP, _GatherFromTP, _tp)
from ..framework.lazy import parameter
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.norm import LayerNorm
from .gpt import _dropout, _ReplicatedMasks

__all__ = ["BertConfig", "BertSelfAttention", "BertBlock", "BertEmbeddings",
           "Bert", "BertForPretraining", "bert_tiny"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: int = 0            # default 4*hidden
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # MLM head gather width: only each row's first `max_predictions`
    # masked positions run the transform and the vocab product
    # (the reference data pipeline's masked_lm_positions). 0 = the
    # full-sequence head.
    max_predictions: int = 0

    def __post_init__(self):
        if not self.ffn_hidden_size:
            self.ffn_hidden_size = 4 * self.hidden_size

    @staticmethod
    def bert_base():
        return BertConfig()

    @staticmethod
    def bert_large():
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16)

    def num_params(self) -> int:
        h, L = self.hidden_size, self.num_layers
        per_block = 4 * h * h + 2 * h * self.ffn_hidden_size + 13 * h
        emb = (self.vocab_size + self.max_seq_len +
               self.type_vocab_size) * h
        return emb + L * per_block + 2 * h

    def flops_per_token(self, seq_len=None) -> float:
        """Training FLOPs a token, the reference's ``6N + 12·L·h·s``: it
        counts neither the second half of the non-causal attention nor
        the MLM and NSP heads' own work."""
        s = seq_len or self.max_seq_len
        return 6.0 * self.num_params() + 12.0 * self.num_layers * \
            self.hidden_size * s


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        init = I.Normal(0.0, c.initializer_range)
        tp = _tp()[0]
        if c.num_heads % tp:
            raise ValueError(f"num_heads {c.num_heads} does not split over "
                             f"tp={tp}")
        self.num_heads = c.num_heads // tp        # this rank's heads
        self.head_dim = c.hidden_size // c.num_heads
        self.qkv_proj = ColumnParallelLinear(
            c.hidden_size, 3 * c.hidden_size, weight_attr=init,
            gather_output=False, device=device)
        # the reference's specs P(None, "tp") / P("tp"), cut on the heads
        # of the [3, H, D] columns (as GPTAttention's)
        view = ((3, c.num_heads, self.head_dim), 1)
        self.qkv_proj.shard_views = {"weight": view, "bias": view}
        self.out_proj = RowParallelLinear(
            c.hidden_size, c.hidden_size, weight_attr=init,
            input_is_parallel=True, device=device)
        self.dropout = c.dropout

    def forward(self, x, attn_mask=None):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False,
            dropout_p=self.dropout, training=self.training)
        return self.out_proj(out.reshape(b, s, self.num_heads *
                                         self.head_dim))


class BertBlock(nn.Module):
    """Post-norm encoder block; the same structure every layer."""

    def __init__(self, config: BertConfig, device=None, masks=None):
        super().__init__()
        c = config
        init = I.Normal(0.0, c.initializer_range)
        self.attn = BertSelfAttention(c, device=device)
        self.ln_1 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                              device=device)
        self.fc_in = ColumnParallelLinear(c.hidden_size, c.ffn_hidden_size,
                                          weight_attr=init,
                                          gather_output=False, device=device)
        self.fc_out = RowParallelLinear(c.ffn_hidden_size, c.hidden_size,
                                        weight_attr=init,
                                        input_is_parallel=True,
                                        device=device)
        self.ln_2 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                              device=device)
        self.dropout = c.dropout
        self._masks = masks

    def forward(self, x, attn_mask=None):
        a = self.attn(x, attn_mask)
        x = self.ln_1(x + _dropout(a, self.dropout, self.training,
                                   self._masks))
        m = self.fc_out(TF.gelu(self.fc_in(x)))
        return self.ln_2(x + _dropout(m, self.dropout, self.training,
                                      self._masks))


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None, masks=None):
        super().__init__()
        c = config
        init = I.Normal(0.0, c.initializer_range)
        self.word = VocabParallelEmbedding(c.vocab_size, c.hidden_size,
                                           weight_attr=init, device=device)
        self.position = Embedding(c.max_seq_len, c.hidden_size,
                                  weight_attr=init, device=device)
        self.token_type = Embedding(c.type_vocab_size, c.hidden_size,
                                    weight_attr=init, device=device)
        self.ln = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                            device=device)
        self.dropout = c.dropout
        self._masks = masks

    def forward(self, tokens, token_type_ids=None):
        s = tokens.shape[1]
        pos = torch.arange(s, device=tokens.device)
        x = self.word(tokens) + self.position(pos)[None]
        if token_type_ids is not None:
            x = x + self.token_type(token_type_ids)
        return _dropout(self.ln(x), self.dropout, self.training, self._masks)


class Bert(nn.Module):
    """The encoder stack; ``forward`` returns ``(sequence_output,
    pooled_output)``, the pooled one ``tanh(pooler(x[:, 0]))``."""

    def __init__(self, config: BertConfig, device=None, masks=None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device=device, masks=masks)
        self.blocks = nn.ModuleList([BertBlock(config, device=device,
                                               masks=masks)
                                     for _ in range(config.num_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             device=device)

    def forward(self, tokens, token_type_ids=None, attn_mask=None):
        x = self.embeddings(tokens, token_type_ids)
        for blk in self.blocks:
            x = blk(x, attn_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


def _masked_positions(mlm_labels, maxp: int):
    """(positions [B, maxp], 0/1 scores) of each row's first ``maxp``
    masked positions, then its unmasked ones: a stable descending sort
    of the mask, the order ``jax.lax.top_k`` gives (ties lowest index
    first)."""
    from ..ops.fused_ce import IGNORE

    is_masked = (mlm_labels != IGNORE).to(torch.int32)
    score, pos = torch.sort(is_masked, dim=1, descending=True, stable=True)
    return pos[:, :maxp], score[:, :maxp]


class BertForPretraining(nn.Module):
    """The MLM and NSP heads over ``Bert``. ``loss(tokens, token_type_ids,
    mlm_labels, nsp_labels)``; ``mlm_labels`` is -100 where a position is
    not predicted. ``device=None`` means ``"cuda"``; pass ``device="cpu"``
    to run the plain versions on the CPU."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        dev = resolve_device(device)
        self.config = c
        tp, mesh = _tp()
        masks = None
        if tp > 1:
            # the replicated regions' dropout masks: equal on every rank
            # of a tp group
            dp_index = mesh.axis_index("dp") if "dp" in mesh.axis_names \
                else 0
            masks = _ReplicatedMasks(dev, dp_index)
        self.bert = Bert(c, device=dev, masks=masks)
        self.mlm_transform = Linear(c.hidden_size, c.hidden_size,
                                    device=dev)
        self.mlm_ln = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                device=dev)
        # the tied decoder's bias: this rank's vocab shard at tp > 1
        self.mlm_bias = parameter((c.vocab_size // tp,), I.Constant(0.0),
                                  dev)
        self.nsp_head = Linear(c.hidden_size, 2, device=dev)
        self._mesh = mesh
        self.param_shardings = {"mlm_bias": P("tp")}

    def forward(self, tokens, token_type_ids=None, attn_mask=None):
        """``(mlm_logits [B, S, V], nsp_logits [B, 2])``."""
        seq, pooled = self.bert(tokens, token_type_ids, attn_mask)
        h = self.mlm_ln(TF.gelu(self.mlm_transform(seq)))
        w = self.bert.embeddings.word.weight
        if self._mesh is None:
            mlm = h @ w.T + self.mlm_bias
        else:
            h = _CopyToTP.apply(h, self._mesh.group("tp"))
            mlm = _GatherFromTP.apply(h @ w.T + self.mlm_bias, self._mesh)
        return mlm, self.nsp_head(pooled)

    # --- pipeline protocol (distributed/hybrid.py) -----------------------
    def pipeline_stem(self, tokens, token_type_ids, mlm_labels, nsp_labels):
        return self.bert.embeddings(tokens, token_type_ids)

    def pipeline_stem_spec(self, tokens, token_type_ids, mlm_labels,
                           nsp_labels):
        """(shape, dtype) of ``pipeline_stem(...)``: what a pipeline stage
        after the first receives."""
        return ((tokens.shape[0], tokens.shape[1], self.config.hidden_size),
                self.bert.embeddings.word.weight.dtype)

    def pipeline_blocks(self):
        return self.bert.blocks

    def pipeline_loss_totals(self, tokens, token_type_ids, mlm_labels,
                             nsp_labels):
        """The global batch's counts of the head's two means, as 0-dim
        tensors (no host sync): the masked positions the MLM head
        predicts (at most ``max_predictions`` a row when it gathers) and
        the NSP rows. The trainers hand them to ``pipeline_head`` through
        ``context.loss_totals_scope`` (module docstring)."""
        from ..ops.fused_ce import IGNORE

        per_row = (mlm_labels != IGNORE).sum(1)
        maxp = int(self.config.max_predictions or 0)
        if maxp and maxp < mlm_labels.shape[1]:
            per_row = per_row.clamp(max=maxp)
        return per_row.sum(), (nsp_labels != IGNORE).sum()

    def pipeline_head(self, x, tokens, token_type_ids, mlm_labels,
                      nsp_labels):
        """The MLM loss through the fused tied-decoder CE plus the NSP
        loss on the pooled CLS row (its logits in f32). CLS is taken
        before the masked-position gather. Inside
        ``context.loss_totals_scope`` each term is its sum over the
        scope's global count."""
        from ..distributed.context import (current_loss_totals,
                                           current_sequence_parallel)
        from ..ops.fused_ce import IGNORE, fused_linear_cross_entropy

        cls = x[:, 0]
        maxp = int(self.config.max_predictions or 0)
        if maxp and maxp < mlm_labels.shape[1]:
            pos, score = _masked_positions(mlm_labels, maxp)
            x = x.gather(1, pos[..., None].expand(-1, -1, x.shape[-1]))
            mlm_labels = torch.where(score > 0, mlm_labels.gather(1, pos),
                                     torch.full_like(pos, IGNORE)
                                     .to(mlm_labels.dtype))
        h = self.mlm_ln(TF.gelu(self.mlm_transform(x)))
        sp = current_sequence_parallel()
        mlm = fused_linear_cross_entropy(
            h, self.bert.embeddings.word.weight, mlm_labels,
            bias=self.mlm_bias, chunk=None if sp is not None else 256,
            mesh=self._mesh)
        pooled = torch.tanh(self.bert.pooler(cls))
        nsp = TF.cross_entropy(self.nsp_head(pooled).float(),
                               nsp_labels.long(), ignore_index=IGNORE)
        totals = current_loss_totals()
        if totals is not None:
            n_mlm, n_rows = totals
            mlm = mlm * ((mlm_labels != IGNORE).sum()
                         / n_mlm.clamp(min=1)).float()
            nsp = nsp * ((nsp_labels != IGNORE).sum()
                         / n_rows.clamp(min=1)).float()
        loss = mlm + nsp
        if sp is None:
            return loss
        from ..distributed.pipeline import _global_share

        mesh, axis, _ = sp
        return _global_share(loss / mesh.shape[axis], loss)

    def loss(self, tokens, token_type_ids, mlm_labels, nsp_labels):
        """The pretraining loss through ``pipeline_head``: the ``[B, S,
        V]`` logits never exist."""
        x = self.pipeline_stem(tokens, token_type_ids, mlm_labels,
                               nsp_labels)
        for blk in self.bert.blocks:
            x = blk(x)
        return self.pipeline_head(x, tokens, token_type_ids, mlm_labels,
                                  nsp_labels)


def bert_tiny(device=None, **kw):
    """Small config for tests."""
    cfg = BertConfig(vocab_size=128, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=64, type_vocab_size=2, **kw)
    return BertForPretraining(cfg, device=device)
