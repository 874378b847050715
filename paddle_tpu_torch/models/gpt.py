"""GPT (mirrors ``paddle_tpu/models/gpt.py``).

Parameter names and layouts equal the reference's ``state_dict()``:
``Linear`` weights are ``[in, out]`` applied as ``x @ W``, the fused QKV
projection interleaves q|k|v on its output columns, and the head is tied
to ``embeddings.wte.weight`` (``x @ wte.T``). ``load_reference_state``
copies the reference's weights in without transposes and
``state_to_numpy`` hands them back.

Paths:

- ``GPT.forward(tokens)`` -> logits; each block's attention goes through
  ``nn.functional.scaled_dot_product_attention``, which reaches the flash
  kernels where the reference reaches its Pallas kernels.
- ``GPT.loss(tokens, labels=None)`` -> the shifted next-token cross
  entropy through the fused lm-head loss (``ops/fused_ce.py``), and the
  pipeline protocol the trainer drives (``pipeline_stem``,
  ``pipeline_blocks``, ``pipeline_head``; ``distributed/hybrid.py``).
  Backward runs the flash backward kernels.
- ``gpt_ragged_apply`` — the serving engine's mixed prefill/decode
  forward over the paged KV cache, written over the per-layer decode
  state (``_gpt_decode_state``); a Python loop over layers replaces the
  reference's ``lax.scan``. ``gpt_paged_suffix_apply`` runs one slot's
  prompt chunk as one ragged row of it (the legacy engine's prefill).
- ``GPT.generate`` — greedy, sampling and beam search
  (``ops/decoding.py``) over the dense KV cache (``gpt_cached_apply``,
  plain attention as in the reference), or greedy and sampling over the
  paged serving engine with ``paged=True``. ``GPTForGeneration`` wraps
  it as a module.

Under a mesh whose ``tp`` axis is > 1 (``distributed.mesh.init_mesh``
before the model is built) the heads split over ``tp``: each rank holds
``num_heads / tp`` heads (the qkv projection's shard holds q, k and v of
those heads: ``parallel_layers.shard_reference_state``), the out and fc
projections are row-parallel over an already-parallel input, the
embedding table and the tied head are vocab-sharded, ``forward``
gathers the logits' vocab shards and ``pipeline_head`` runs the
vocab-parallel fused loss. Dropout at tp > 1: the masks of the
replicated regions (after the embeddings, after each MLP's row layer)
are equal on every rank of a ``tp`` group (``_ReplicatedMasks``): inside
a ``core.rng.key_scope`` (the trainer opens one a micro-batch and one a
block) a mask is a pure function of the scope's key, its draw's place
in the scope and the rank's ``dp`` coordinate, so a block that
``torch.utils.checkpoint`` recomputes draws the same masks again;
outside every scope they come from a generator seeded by the ``dp``
coordinate only, which checkpoint does not restore. Attention-probability
dropout on the local heads uses the device's default generator. Serving
and ``generate`` under tp > 1 or a pipeline are ROADMAP queue 1 item 8c.

MoE (``moe_num_experts > 0``): each block's FFN is a
``distributed.moe.MoEMLP`` (top-k routing with a capacity, the Switch
load-balance loss at ``mlp.aux_loss``; built under a mesh whose ``ep``
axis is > 1 a block holds ``E/ep`` experts), and ``GPT.loss`` adds
``moe_aux_weight`` times each block's aux loss, as the reference's.
MoE decode raises, as in the reference.

Sequence parallelism: inside ``distributed.context.
sequence_parallel_scope`` (the trainer opens it at ``sp`` > 1) every
rank holds the sequence shard ``[i·S/sp, (i+1)·S/sp)`` of the batch's
dim 1: ``pipeline_stem`` embeds the shard of the GLOBAL tokens it is
given at positions from ``i·S/sp`` (for ``wpe``), attention runs the
ring over ``sp`` (``ops/ring_attention.py``; attention-probability
dropout raises there, as in the reference), and ``pipeline_head`` runs
one chunk over the shard with the next-token labels of the global
tokens (the last position of shard i is labelled by the first token of
shard i + 1; the global last position has none). The head's value is
the global mean (local sums over the global count, summed over
``sp``); its gradient is the rank's own share.

Not in this slice: the export of ``GPTForGeneration`` (ROADMAP queue 1
item 9).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as TF

from ..core.place import resolve_device
from ..core import rng as _rng
from ..framework.lazy import in_lazy_mode, is_abstract
from ..distributed.parallel_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding,
                                           _CopyToTP, _GatherFromTP, _tp)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Embedding
from ..nn.layer.norm import LayerNorm


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_hidden_size: int = 0          # default 4*hidden
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_flash_attention: bool = True
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if not self.ffn_hidden_size:
            self.ffn_hidden_size = 4 * self.hidden_size

    # presets from the reference north-star table (BASELINE.md)
    @staticmethod
    def gpt3_125m():
        return GPTConfig(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def gpt3_350m():
        return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16)

    @staticmethod
    def gpt3_1_3b():
        return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         max_seq_len=2048)

    @staticmethod
    def gpt3_2_7b():
        return GPTConfig(hidden_size=2560, num_layers=32, num_heads=32,
                         max_seq_len=2048)

    @staticmethod
    def gpt3_6_7b():
        return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                         max_seq_len=2048)

    @staticmethod
    def gpt3_13b():
        return GPTConfig(hidden_size=5120, num_layers=40, num_heads=40,
                         max_seq_len=2048)

    def num_params(self) -> int:
        h, L, v = self.hidden_size, self.num_layers, self.vocab_size
        e = max(self.moe_num_experts, 1)
        ffn = 2 * h * self.ffn_hidden_size * e \
            + (e - 1) * (self.ffn_hidden_size + h) \
            + (h * e if self.moe_num_experts else 0)
        per_block = 4 * h * h + ffn + 13 * h
        return v * h + self.max_seq_len * h + L * per_block + 2 * h

    def flops_per_token(self, seq_len=None) -> float:
        """Training FLOPs/token ~ 6N + 12*L*h*s (attention term)."""
        s = seq_len or self.max_seq_len
        return 6.0 * self.num_params() + 12.0 * self.num_layers * \
            self.hidden_size * s


class _ReplicatedMasks:
    """The generator of the replicated regions' dropout masks at tp > 1
    (the module docstring): reseeded from ``core.rng.scope_key()`` and
    the ``dp`` coordinate at each draw inside a key scope, else drawn on
    from its seed (the port's seed and the ``dp`` coordinate). A model
    built under ``LazyGuard`` makes it at its first draw (on the device
    its parameters were materialized on)."""

    def __init__(self, dev, dp_index: int):
        self.dp_index = dp_index
        self.gen = None if in_lazy_mode() else self._make(dev)

    def _make(self, dev) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(
            _rng.generator(dev).initial_seed() + 7919 * (1 + self.dp_index))

    def generator(self, dev) -> torch.Generator:
        if self.gen is None:
            self.gen = self._make(dev)
        key = _rng.scope_key()
        if key is not None:
            self.gen.manual_seed(_rng.fold_in(key, self.dp_index))
        return self.gen


def _dropout(x, p: float, training: bool, masks=None):
    """``TF.dropout``, or with ``masks`` (tp > 1: the replicated regions'
    ``_ReplicatedMasks``) a mask drawn from its generator. A plan's fake
    ``x`` (``distributed/plan.py``) draws from no generator: its mask has
    the shape and no values."""
    if masks is None or not training or not p:
        return TF.dropout(x, p, training=training)
    gen = None if is_abstract(x) else masks.generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def _inits(c: GPTConfig):
    return (I.Normal(0.0, c.initializer_range),
            I.Normal(0.0, c.initializer_range / math.sqrt(2 * c.num_layers)))


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        c = config
        init, out_init = _inits(c)
        tp = _tp()[0]
        if c.num_heads % tp:
            raise ValueError(f"num_heads {c.num_heads} does not split over "
                             f"tp={tp}")
        self.num_heads = c.num_heads // tp        # this rank's heads
        self.head_dim = c.hidden_size // c.num_heads
        self.qkv_proj = ColumnParallelLinear(
            c.hidden_size, 3 * c.hidden_size, weight_attr=init,
            gather_output=False, device=device)
        # param_shardings stay the reference's P(None, "tp") / P("tp")
        # (models/gpt.py:121-122); the shard is cut on the heads of the
        # [3, H, D] columns
        view = ((3, c.num_heads, self.head_dim), 1)
        self.qkv_proj.shard_views = {"weight": view, "bias": view}
        self.out_proj = RowParallelLinear(
            c.hidden_size, c.hidden_size, weight_attr=out_init,
            input_is_parallel=True, device=device)
        self.dropout = c.dropout

    def forward(self, x):
        from ..distributed.context import current_sequence_parallel

        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        sp = current_sequence_parallel()
        if sp is not None:
            # the ring over 'sp' (ops/ring_attention.py); its chunks
            # never hold the probabilities, so their dropout cannot run
            from ..ops.ring_attention import sequence_parallel_attention

            if self.dropout and self.training:
                raise NotImplementedError(
                    "attention-probability dropout is not supported under "
                    "sequence parallelism (ring attention); set "
                    "GPTConfig.dropout=0 or sp_degree=1")
            mesh, axis, _manual = sp
            out = sequence_parallel_attention(q, k, v, mesh, causal=True,
                                              axis_name=axis)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout,
                training=self.training)
        return self.out_proj(out.reshape(b, s, self.num_heads *
                                         self.head_dim))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, masks=None):
        super().__init__()
        c = config
        init, out_init = _inits(c)
        self.fc_in = ColumnParallelLinear(c.hidden_size, c.ffn_hidden_size,
                                          weight_attr=init,
                                          gather_output=False,
                                          device=device)
        self.fc_out = RowParallelLinear(c.ffn_hidden_size, c.hidden_size,
                                        weight_attr=out_init,
                                        input_is_parallel=True,
                                        device=device)
        self.dropout = c.dropout
        self._masks = masks

    def forward(self, x):
        x = TF.gelu(self.fc_in(x), approximate="tanh")
        x = self.fc_out(x)
        return _dropout(x, self.dropout, self.training, self._masks)


class GPTBlock(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, config: GPTConfig, device=None, masks=None):
        super().__init__()
        self.ln_1 = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=device)
        self.attn = GPTAttention(config, device=device)
        self.ln_2 = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=device)
        if config.moe_num_experts > 0:
            from ..distributed.moe import MoEMLP

            self.mlp = MoEMLP(config.hidden_size, config.ffn_hidden_size,
                              config.moe_num_experts,
                              top_k=config.moe_top_k,
                              capacity_factor=config.moe_capacity_factor,
                              initializer_range=config.initializer_range,
                              device=device)
        else:
            self.mlp = GPTMLP(config, device=device, masks=masks)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        x = x + self.mlp(self.ln_2(x))
        return x


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, device=None, masks=None):
        super().__init__()
        c = config
        self.wte = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size,
            weight_attr=I.Normal(0.0, c.initializer_range), device=device)
        self.wpe = Embedding(
            c.max_seq_len, c.hidden_size,
            weight_attr=I.Normal(0.0, c.initializer_range), device=device)
        self.dropout = c.dropout
        self._masks = masks

    def forward(self, tokens, pos0: int = 0):
        s = tokens.shape[1]
        pos = torch.arange(pos0, pos0 + s, device=tokens.device)
        x = self.wte(tokens) + self.wpe(pos)[None]
        return _dropout(x, self.dropout, self.training, self._masks)


class GPT(nn.Module):
    """Decoder-only GPT. ``forward`` returns logits ``[B, S, V]``;
    ``loss`` computes the shifted next-token cross entropy.

    ``device=None`` means ``"cuda"`` (and raises without a CUDA device);
    pass ``device="cpu"`` to run the plain versions on the CPU. Built
    under a mesh whose ``tp`` axis is > 1, the model is this rank's shard
    (the module docstring).
    """

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        tp, mesh = _tp()
        masks = None
        if tp > 1:
            # the replicated regions' dropout masks: equal on every rank
            # of a tp group
            dp_index = mesh.axis_index("dp") if "dp" in mesh.axis_names \
                else 0
            masks = _ReplicatedMasks(dev, dp_index)
        self.embeddings = GPTEmbeddings(config, device=dev, masks=masks)
        self.blocks = nn.ModuleList([GPTBlock(config, device=dev,
                                              masks=masks)
                                     for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=dev)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                weight_attr=I.Normal(0.0, config.initializer_range),
                gather_output=True, device=dev)

    @property
    def device(self) -> torch.device:
        return self.embeddings.wte.weight.device

    @property
    def _tp_mesh(self):
        """The mesh the vocab is sharded over (None at tp 1)."""
        return self.embeddings.wte._mesh

    def forward(self, tokens):
        x = self.embeddings(tokens)
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        if self.config.tie_word_embeddings:
            mesh = self._tp_mesh
            if mesh is None:
                return x @ self.embeddings.wte.weight.T
            x = _CopyToTP.apply(x, mesh.group("tp"))
            return _GatherFromTP.apply(x @ self.embeddings.wte.weight.T,
                                       mesh)
        return self.lm_head(x)

    # --- pipeline protocol (distributed/hybrid.py) -----------------------
    @staticmethod
    def _sp_shard(s: int):
        """(first position, length) of this rank's sequence shard of
        ``s`` positions under a sequence-parallel scope, else None."""
        from ..distributed.context import current_sequence_parallel

        sp = current_sequence_parallel()
        if sp is None:
            return None
        mesh, axis, _ = sp
        n = mesh.shape[axis]
        if s % n:
            raise ValueError(f"sequence {s} does not split over {axis}={n}")
        return mesh.axis_index(axis) * (s // n), s // n

    def pipeline_stem(self, tokens):
        """Embeddings of ``tokens`` (under sp: of this rank's shard of
        the global tokens, at its global positions)."""
        shard = self._sp_shard(tokens.shape[1])
        if shard is None:
            return self.embeddings(tokens)
        p0, n = shard
        return self.embeddings(tokens[:, p0:p0 + n], pos0=p0)

    def pipeline_stem_spec(self, tokens):
        """(shape, dtype) of ``pipeline_stem(tokens)``: what a pipeline
        stage after the first receives."""
        shard = self._sp_shard(tokens.shape[1])
        s = tokens.shape[1] if shard is None else shard[1]
        return ((tokens.shape[0], s, self.config.hidden_size),
                self.embeddings.wte.weight.dtype)

    def pipeline_blocks(self):
        return self.blocks

    def pipeline_head(self, x, tokens, labels=None):
        """Final norm + fused lm-head/CE (``ops/fused_ce.py``): the [B,S,V]
        logits never exist. ``labels``: explicit targets instead of the
        shifted-token LM objective. Under sp ``x`` is this rank's shard
        and ``tokens``/``labels`` are global (the module docstring)."""
        from ..ops.fused_ce import (IGNORE, fused_linear_cross_entropy,
                                    shifted_labels)

        x = self.ln_f(x)
        lbl, next_token = (tokens, True) if labels is None \
            else (labels, False)
        shard = self._sp_shard(lbl.shape[1])
        chunk = 256
        if shard is not None:
            full = shifted_labels(lbl) if next_token else lbl
            p0, n = shard
            lbl, next_token, chunk = full[:, p0:p0 + n], False, None
        if self.config.tie_word_embeddings:
            loss = fused_linear_cross_entropy(
                x, self.embeddings.wte.weight, lbl, chunk=chunk,
                next_token=next_token, mesh=self._tp_mesh)
        else:
            loss = fused_linear_cross_entropy(
                x, self.lm_head.weight, lbl, chunk=chunk, transpose_w=True,
                next_token=next_token, mesh=self.lm_head._mesh)
        if shard is None:
            return loss
        # the shard's share of the global mean; the value summed over sp
        from ..distributed.context import current_sequence_parallel
        from ..distributed.pipeline import _global_share, _psum

        mesh, axis, _ = current_sequence_parallel()
        share = loss * ((lbl != IGNORE).sum() / (full != IGNORE).sum()
                        .clamp(min=1)).float()
        return _global_share(share, _psum(share.detach(), mesh, axis))

    def pipeline_label_count(self, tokens, labels=None):
        """Non-ignored targets of ``pipeline_head`` for this batch: the
        trainer weighs each micro-batch's mean by it, so that the
        accumulated loss is the whole batch's mean."""
        from ..ops.fused_ce import IGNORE

        if labels is None:
            return tokens.shape[0] * (tokens.shape[1] - 1)
        return int((labels != IGNORE).sum())

    def loss(self, tokens, labels=None):
        """Next-token LM loss (labels default: tokens shifted left),
        through the fused lm-head/CE as ``pipeline_head``, plus
        ``moe_aux_weight`` times each MoE block's load-balance loss."""
        x = self.pipeline_stem(tokens)
        for blk in self.blocks:
            x = blk(x)
        loss = self.pipeline_head(x, tokens, labels=labels)
        if self.config.moe_num_experts > 0:
            for blk in self.blocks:
                loss = loss + self.config.moe_aux_weight * blk.mlp.aux_loss
        return loss

    def _decode_state(self):
        """(per-layer params, other params) views of the live weights for
        ``gpt_ragged_apply`` and ``gpt_cached_apply``; they share storage
        with the parameters, so an in-place weight update is seen without
        a rebuild."""
        return _gpt_decode_state(self)

    # --- decoding (ops/decoding.py loops over the KV-cached forward) -----
    #: LRU capacity for cached paged serving engines (``paged=True``)
    PAGED_ENGINE_CACHE_SIZE = 4

    def generate(self, input_ids, max_new_tokens: int = 32,
                 decode_strategy: str = "greedy_search", top_k: int = 0,
                 top_p: float = 1.0, temperature: float = 1.0,
                 num_beams: int = 4, length_penalty: float = 0.0,
                 eos_token_id=None, seed: int = 0, paged: bool = False,
                 page_size: int = 0, kv_dtype=None):
        """Autoregressive generation with a preallocated KV cache: a
        prefill through ``gpt_cached_apply``, then the ``ops.decoding``
        loop, one cached step a token.

        decode_strategy: 'greedy_search' | 'sampling' | 'beam_search'.
        Returns ``(ids [B, max_new_tokens] int64, scores [B] f32)`` on the
        model's device (scores are the best beam's under beam search,
        zeros otherwise). Sampling draws from ``core.random`` keys, the
        threefry generator bit-equal to ``jax.random``: the same ``seed``
        gives the reference's tokens on the same logits.

        ``paged=True`` serves the rows through ``serving.ServingEngine``
        (one slot a row, slot capacity prompt + max_new_tokens, page size
        the largest of 16/8/4/2/1 dividing it unless ``page_size`` is
        given; row ``i`` draws from ``fold_in(PRNGKey(seed), i)``), so the
        paged attention kernel serves it on a card. Beam search has no
        paged path. ``kv_dtype`` (paged only) is the page pool's storage
        dtype (``None``, 'f32', 'bf16' or 'int8').

        The reference compiles each (shape, strategy) into one program
        and keeps the executables in an LRU (``GEN_JIT_CACHE_SIZE``). The
        dense path here runs eagerly and has no compiled program to hold;
        a CUDA graph for each shape would be its counterpart (ROADMAP).
        """
        from ..core import random as R
        from ..ops import decoding as D

        dev = self.device
        ids_v = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids).to(dev).long()
        b, t0 = ids_v.shape
        smax = t0 + max_new_tokens
        if smax > self.config.max_seq_len:
            raise ValueError(
                f"prompt {t0} + max_new_tokens {max_new_tokens} exceeds "
                f"max_seq_len {self.config.max_seq_len}")
        if decode_strategy not in ("greedy_search", "sampling",
                                   "beam_search"):
            raise ValueError(f"unknown decode_strategy {decode_strategy!r}")
        if paged:
            if decode_strategy == "beam_search":
                raise NotImplementedError(
                    "paged decode supports greedy_search/sampling; beam "
                    "reordering needs per-beam page aliasing (ROADMAP)")
            return self._generate_paged(
                ids_v.cpu().numpy().astype(np.int32), max_new_tokens,
                decode_strategy, top_k, top_p, temperature, eos_token_id,
                seed, page_size, kv_dtype)
        if kv_dtype is not None:
            raise ValueError("kv_dtype is a paged-cache knob; the dense "
                             "cache follows the model dtype (use "
                             "paged=True)")
        stacked, other = self._decode_state()
        cfg = self.config
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        dt = other["embeddings.wte.weight"].dtype
        with torch.inference_mode():
            ck = torch.zeros((b, cfg.num_layers, smax, nh, hd), dtype=dt,
                             device=dev)
            cv = torch.zeros_like(ck)
            logits, ck, cv = gpt_cached_apply(cfg, stacked, other, ck, cv,
                                              ids_v, 0)

            def step(cache, tok, pos):
                ck, cv = cache
                lg, ck, cv = gpt_cached_apply(cfg, stacked, other, ck, cv,
                                              tok[:, None], pos)
                return lg, (ck, cv)

            if decode_strategy == "beam_search":
                cache = D.tile_cache_for_beams((ck, cv), num_beams)
                return D.beam_search_decode(
                    step, cache, logits, t0, max_new_tokens, num_beams,
                    length_penalty=length_penalty,
                    eos_token_id=eos_token_id)
            if decode_strategy == "sampling":
                ids, _ = D.sampling_decode(
                    step, (ck, cv), logits, t0, max_new_tokens,
                    R.PRNGKey(seed, device=dev), top_k=top_k, top_p=top_p,
                    temperature=temperature, eos_token_id=eos_token_id)
            else:
                ids, _ = D.greedy_decode(step, (ck, cv), logits, t0,
                                         max_new_tokens,
                                         eos_token_id=eos_token_id)
        return ids, torch.zeros(b, dtype=torch.float32, device=dev)

    def _weights_token(self):
        """Changes when a parameter is replaced (its storage) or updated
        in place (its version counter): a cached paged engine serves views
        of the weights, but its prefix cache holds K/V computed from the
        values it saw, so it is rebuilt on either."""
        return tuple((p.data_ptr(), p._version) for p in self.parameters())

    def _generate_paged(self, ids_np, max_new_tokens, decode_strategy,
                        top_k, top_p, temperature, eos_token_id, seed,
                        page_size, kv_dtype=None):
        """``generate()`` over the paged serving engine: one slot a batch
        row, slot capacity the dense path's S_max."""
        from ..core import random as R
        from ..serving import ServingConfig, ServingEngine
        from ..utils.lru import LRUCache

        b, t0 = ids_np.shape
        smax = t0 + max_new_tokens
        ps = page_size
        if not ps:
            ps = next(p for p in (16, 8, 4, 2, 1) if smax % p == 0)
        if smax % ps:
            raise ValueError(
                f"page_size {ps} must divide prompt+max_new_tokens "
                f"{smax} for the paged generate() path (slot capacity == "
                "dense S_max)")
        strategy = "sampling" if decode_strategy == "sampling" else "greedy"
        ekey = (b, t0, max_new_tokens, ps, strategy, top_k, top_p,
                temperature, eos_token_id, kv_dtype)
        if "_paged_engines" not in self.__dict__:
            self.__dict__["_paged_engines"] = LRUCache(
                GPT.PAGED_ENGINE_CACHE_SIZE, "gpt_paged_engine")
        engines = self.__dict__["_paged_engines"]
        token = self._weights_token()
        hit = engines.get(ekey)
        if hit is not None and hit[0] == token:
            eng = hit[1]
        else:
            eng = ServingEngine(self, ServingConfig(
                num_slots=b, page_size=ps, pages_per_slot=smax // ps,
                prefill_chunk=t0, decode=strategy,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_token_id=eos_token_id, seed=seed, kv_dtype=kv_dtype))
            engines[ekey] = (token, eng)
        # row keys are host metadata, folded on the CPU; greedy rows draw
        # nothing and take the engine's zero key
        keys = (R.key_to_numpy(R.fold_in(R.PRNGKey(seed, device="cpu"),
                                         torch.arange(b)))
                if strategy == "sampling" else [None] * b)
        rids = [eng.submit(ids_np[i], max_new_tokens, key=keys[i])
                for i in range(b)]
        results = eng.run()
        out = np.full((b, max_new_tokens),
                      eos_token_id if eos_token_id is not None else 0,
                      np.int64)
        for i, rid in enumerate(rids):
            row = results[rid][:max_new_tokens]
            out[i, :row.shape[0]] = row
        eng.reset_results()
        dev = self.device
        return (torch.from_numpy(out).to(dev),
                torch.zeros(b, dtype=torch.float32, device=dev))


def _ln(x, w, b, eps):
    m = x.mean(dim=-1, keepdim=True)
    var = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(var + eps) * w + b


def gpt_block_body(xc, p, eps, nh, hd, attend):
    """One pre-norm transformer block over the decode params ``p`` (one
    layer's ``{suffix: tensor}``). ``attend(q, kk, vv) -> (o [n, t, nh,
    hd], extra)`` writes this layer's KV into its cache and attends."""
    n, t = xc.shape[0], xc.shape[1]
    h = nh * hd
    hn = _ln(xc, p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = hn @ p["attn.qkv_proj.weight"] + p["attn.qkv_proj.bias"]
    qkv = qkv.reshape(n, t, 3, nh, hd)
    q, kk, vv = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, extra = attend(q, kk, vv)
    o = o.reshape(n, t, h)
    xc = xc + o @ p["attn.out_proj.weight"] + p["attn.out_proj.bias"]
    h2 = _ln(xc, p["ln_2.weight"], p["ln_2.bias"], eps)
    mid = TF.gelu(h2 @ p["mlp.fc_in.weight"] + p["mlp.fc_in.bias"],
                  approximate="tanh")
    xc = xc + mid @ p["mlp.fc_out.weight"] + p["mlp.fc_out.bias"]
    return xc, extra


def gpt_cached_apply(cfg: GPTConfig, stacked, other, ck, cv, tokens, pos0,
                     logits_index=None):
    """KV-cached forward over the dense cache, for decoding.

    ``stacked`` is the list of per-layer param dicts and ``other`` the
    remaining params (``_gpt_decode_state``); ck/cv are ``[N, L, S_max,
    NH, D]`` caches, updated in place; ``tokens`` [N, T] are processed at
    positions ``pos0 .. pos0 + T``. Returns (last-token logits [N, V], ck,
    cv). ``logits_index``: take the logits at that query position instead
    of the last.

    Attention is plain ``torch.matmul``/softmax, as the reference computes
    it outside any Pallas kernel: scores masked at -1e9 past each query's
    position, softmax in f32, cast back. The write of this layer's K/V
    starts at ``pos0`` clamped so that the T rows fit, as
    ``dynamic_update_slice`` clamps it in the reference.
    """
    n, t = tokens.shape
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    eps = cfg.layer_norm_eps
    dev = tokens.device
    wte = other["embeddings.wte.weight"]
    wpe = other["embeddings.wpe.weight"]
    pos = pos0 + torch.arange(t, device=dev)
    x = wte[tokens] + wpe[pos][None]
    smax = ck.shape[2]
    w0 = min(max(int(pos0), 0), smax - t)
    # causal-with-cache mask: query i sees cache positions <= pos0 + i
    mask = torch.arange(smax, device=dev)[None, None, None, :] <= \
        pos[None, None, :, None]
    scale = math.sqrt(hd)
    for layer, p in enumerate(stacked):
        k_c, v_c = ck[:, layer], cv[:, layer]            # [N, S, NH, D]

        def attend(q, kk, vv):
            k_c[:, w0:w0 + t] = kk
            v_c[:, w0:w0 + t] = vv
            att = torch.einsum("btnd,bsnd->bnts", q, k_c) / scale
            att = torch.where(mask, att, -1e9)
            w = torch.softmax(att.float(), dim=-1).to(x.dtype)
            return torch.einsum("bnts,bsnd->btnd", w, v_c), None

        x, _ = gpt_block_body(x, p, eps, nh, hd, attend)
    x = _ln(x, other["ln_f.weight"], other["ln_f.bias"], eps)
    last = x[:, -1] if logits_index is None else x[:, logits_index]
    if "lm_head.weight" in other:
        logits = last @ other["lm_head.weight"]
    else:
        logits = last @ wte.T
    return logits, ck, cv


def gpt_ragged_apply(cfg: GPTConfig, stacked, other, kpool, vpool,
                     tokens, tok_pos, tok_limit, row_tab, row_pos0,
                     row_len, sample_ix, decode_rows: int,
                     chunk_width: int, spec_k: int = 0, kscale=None,
                     vscale=None):
    """Mixed prefill/decode forward over the PAGED cache: every token in
    flight rides one call. ``tokens`` [NT] is the flat token buffer of
    one serving tick — ``decode_rows`` resident decode tokens followed by
    the prefill chunks, ``chunk_width`` tokens each:

    tok_pos    [NT] int   absolute cache position of each token
    tok_limit  [NT] int   first non-writable position of the token's
                          sequence; KV writes at ``tok_pos >= tok_limit``
                          go to the null page
    row_tab    [R, NPs]   page-table row per ragged row (int32)
    row_pos0   [R] int32  first query position of each row
    row_len    [R] int32  real queries per row (decode rows: 1)
    sample_ix  [S] int    flat indices whose final hidden states feed
                          the logits head

    ``stacked`` is the list of per-layer param dicts and ``other`` the
    remaining params (``_gpt_decode_state``). ``kpool``/``vpool`` are
    ``[L, P, ps, NH, D]`` and are updated in place. Attention goes
    through ``ops.paged_attention.ragged_paged_attention`` once per row
    group and layer: decode rows as ``[decode_rows, 1]``, chunk rows as
    ``[num_chunks, chunk_width]``. Positions past the position table read
    its last row, as the reference's gather clamps them. Returns (logits
    [S, V], kpool, vpool).

    ``spec_k > 0`` (speculative decoding, ``serving/spec.py``) widens
    each of the ``decode_rows`` slot rows into a verify row of ``1 +
    spec_k`` tokens: the flat buffer becomes ``decode_rows`` last tokens,
    then ``decode_rows * spec_k`` draft tokens (slot-major), then the
    chunks. The slot rows attend as one ``[decode_rows, 1 + spec_k]``
    group and their outputs go back into flat order, so logits can be
    sampled at every verify position. A slot that is not speculating
    rides the group with ``row_len == 1``; its draft positions are pad
    queries (``tok_limit == 0`` sends their KV writes to the null page).

    ``kscale``/``vscale`` [L, P, NH] f32: per-page per-head scales of an
    int8 pool, updated in place like the pools. When given, every token's
    KV write goes through the quantizing ``paged_kv_scatter`` and the
    attention dequantizes with the same scales; the return grows to
    (logits, kpool, vpool, kscale, vscale). Numerics are tolerance, not
    bitwise, against the unquantized pool.
    """
    from ..ops.paged_attention import (paged_kv_scatter,
                                      ragged_paged_attention)

    nt = tokens.shape[0]
    nd = decode_rows
    base = nd * (1 + spec_k)
    nch = (nt - base) // chunk_width if chunk_width else 0
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    eps = cfg.layer_norm_eps
    ps = kpool.shape[2]
    nps = row_tab.shape[1]
    dev = tokens.device
    wte = other["embeddings.wte.weight"]
    wpe = other["embeddings.wpe.weight"]
    tok_pos = tok_pos.long()
    x = (wte[tokens] + wpe[torch.clamp(tok_pos, max=wpe.shape[0] - 1)]
         )[:, None]                                     # [NT, 1, h]
    # token -> ragged row; draft tokens share their slot's row
    parts = [torch.arange(nd, device=dev)]
    if spec_k:
        parts.append(torch.repeat_interleave(
            torch.arange(nd, device=dev), spec_k))
    if nch:
        parts.append(torch.repeat_interleave(
            nd + torch.arange(nch, device=dev), chunk_width))
    tok_row = torch.cat(parts)
    page = torch.where(
        tok_pos < tok_limit,
        row_tab[tok_row, torch.clamp(tok_pos // ps, max=nps - 1)],
        torch.zeros((), dtype=row_tab.dtype, device=dev))
    off = tok_pos % ps

    quantized = kscale is not None
    for layer, p in enumerate(stacked):
        kpl, vpl = kpool[layer], vpool[layer]
        ksl = kscale[layer] if quantized else None
        vsl = vscale[layer] if quantized else None

        def attend(q, kk, vv):
            paged_kv_scatter(kpl, ksl, page, off, kk[:, 0])
            paged_kv_scatter(vpl, vsl, page, off, vv[:, 0])
            outs = []
            if nd and spec_k:
                # verify rows [nd, 1 + spec_k]: each slot's last token and
                # its drafts as one row; outputs back into flat order
                qv = torch.cat([q[:nd], q[nd:base, 0].reshape(
                    nd, spec_k, nh, hd)], dim=1).contiguous()
                ov = ragged_paged_attention(
                    qv, kpl, vpl, row_tab[:nd], row_pos0[:nd],
                    row_len[:nd], k_scale=ksl, v_scale=vsl)
                outs.append(ov[:, :1])
                outs.append(ov[:, 1:].reshape(nd * spec_k, 1, nh, hd))
            elif nd:
                outs.append(ragged_paged_attention(
                    q[:nd].contiguous(), kpl, vpl, row_tab[:nd],
                    row_pos0[:nd], row_len[:nd], k_scale=ksl, v_scale=vsl))
            if nch:
                qp = q[base:, 0].reshape(nch, chunk_width, nh,
                                         hd).contiguous()
                op = ragged_paged_attention(
                    qp, kpl, vpl, row_tab[nd:], row_pos0[nd:],
                    row_len[nd:], k_scale=ksl, v_scale=vsl)
                outs.append(op.reshape(nch * chunk_width, 1, nh, hd))
            return (outs[0] if len(outs) == 1 else torch.cat(outs)), None

        x, _ = gpt_block_body(x, p, eps, nh, hd, attend)
    x = _ln(x, other["ln_f.weight"], other["ln_f.bias"], eps)
    last = x[sample_ix, 0]                              # [S, h]
    if "lm_head.weight" in other:
        logits = last @ other["lm_head.weight"]
    else:
        logits = last @ wte.T
    if quantized:
        return logits, kpool, vpool, kscale, vscale
    return logits, kpool, vpool


def gpt_paged_suffix_apply(cfg: GPTConfig, stacked, other, kpool, vpool,
                           tokens, pos0, true_len, page_row,
                           logits_index, kscale=None, vscale=None):
    """Suffix-prefill forward over the PAGED cache: one prompt chunk
    ``tokens`` [1, T] at positions ``pos0 .. pos0 + T - 1`` of the slot
    whose page-table row is ``page_row`` [NPs] int32, as ONE ragged row of
    ``gpt_ragged_apply`` (``decode_rows=0``, ``chunk_width=T``, row length
    T; writes at positions ``>= true_len`` go to the null page). The
    legacy engine's prefill program. ``pos0``, ``true_len`` and
    ``logits_index`` are ints or one-element tensors on the tokens'
    device. Returns (logits at chunk index ``logits_index`` [1, V], kpool,
    vpool), plus the scales when given."""
    t = tokens.shape[1]
    dev = tokens.device

    def one(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype).reshape(1)

    p0 = one(pos0, torch.int32)
    tok_pos = p0 + torch.arange(t, dtype=torch.int32, device=dev)
    tok_limit = one(true_len, torch.int32).expand(t)
    return gpt_ragged_apply(cfg, stacked, other, kpool, vpool, tokens[0],
                            tok_pos, tok_limit, page_row[None], p0,
                            torch.full((1,), t, dtype=torch.int32,
                                       device=dev),
                            one(logits_index, torch.long), decode_rows=0,
                            chunk_width=t, kscale=kscale, vscale=vscale)


def _gpt_decode_state(model: GPT) -> Tuple[List[Dict[str, torch.Tensor]],
                                           Dict[str, torch.Tensor]]:
    """(per-layer ``{suffix: tensor}`` list, ``{name: tensor}`` of the
    rest) — detached views of the model's parameters. Under tp > 1 or a
    pipeline the serving engine and ``generate`` raise (they read whole
    weights), and a MoE GPT's decode raises, as the reference's."""
    if model.config.moe_num_experts:
        raise NotImplementedError(
            "generate() supports dense GPT; MoE decode needs expert "
            "routing in the cached path")
    if model._tp_mesh is not None or \
            getattr(model, "_pipeline_layout", None) is not None:
        raise NotImplementedError(
            "serving and generate() of a GPT built at tp > 1 or held in "
            "pipeline stages are not ported yet: ROADMAP queue 1 item 8c "
            "(serving at tp > 1)")
    stacked = [{n: t.detach() for n, t in blk.named_parameters()}
               for blk in model.blocks]
    other = {n: t.detach() for n, t in model.named_parameters()
             if not n.startswith("blocks.")}
    return stacked, other


def load_reference_state(model: nn.Module,
                         state: Mapping[str, np.ndarray]) -> None:
    """Copy the reference model's weights — ``{name: np.asarray(p._value)}``
    from the JAX package's ``state_dict()`` — into ``model``. Raises on
    missing, extra or mis-shaped keys. Under a pipeline the blocks of the
    other stages (``model._pipeline_layout``) are not loaded and may be
    missing. An abstract model (built under ``LazyGuard``) has nowhere to
    load into: it raises."""
    if any(is_abstract(p) for p in model.parameters()):
        raise ValueError(
            "load_reference_state: the model is abstract (built under "
            "LazyGuard, or planned by a trainer): its parameters hold no "
            "values; framework.lazy.materialize(model) first")
    own = model.state_dict()
    layout = getattr(model, "_pipeline_layout", None)
    if layout is not None:
        own = {n: t for n, t in own.items() if layout["owner"].get(
            n, layout["stage"]) == layout["stage"]}
        state = {n: a for n, a in state.items()
                 if n in own or n not in layout["owner"]}
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"reference state mismatch: missing {missing}, "
                       f"extra {extra}")
    for name, t in own.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} "
                             f"!= port shape {tuple(t.shape)}")
    with torch.no_grad():
        for name, t in own.items():
            arr = np.asarray(state[name])
            # a writable f32/int copy (ml_dtypes bfloat16 has no torch view)
            arr = np.array(arr, dtype=np.float32 if arr.dtype.kind not in
                           "fiub" else arr.dtype)
            t.copy_(torch.from_numpy(arr).to(t.dtype))


def state_to_numpy(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``load_reference_state``: ``{name: f32 or int numpy
    array}`` of ``model.state_dict()``, comparable with the reference's
    ``{name: np.asarray(p._value)}``."""
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        out[name] = (t.float() if t.is_floating_point() else t).numpy()
    return out


class GPTForGeneration(nn.Module):
    """``forward(tokens)`` runs ``gpt.generate`` and returns the ids. Its
    export (the reference's ``jit.save`` artifact) waits for the jit and
    export slice (ROADMAP queue 1 item 9)."""

    def __init__(self, gpt: GPT, max_new_tokens: int = 16,
                 decode_strategy: str = "greedy_search", **gen_kw):
        super().__init__()
        self.gpt = gpt
        self.max_new_tokens = max_new_tokens
        self.decode_strategy = decode_strategy
        self.gen_kw = gen_kw

    def forward(self, tokens):
        ids, _ = self.gpt.generate(tokens,
                                   max_new_tokens=self.max_new_tokens,
                                   decode_strategy=self.decode_strategy,
                                   **self.gen_kw)
        return ids


def gpt_tiny(device=None, **kw):
    """Small config for tests."""
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=4,
                    num_heads=4, max_seq_len=64, **kw)
    return GPT(cfg, device=device)
