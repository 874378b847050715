"""ERNIE (mirrors ``paddle_tpu/models/ernie.py``): a BERT-style
bidirectional encoder with the MLM and NSP-style pretraining heads under
ERNIE's configurations, the ZeRO-3 + recompute north-star one among
them. It shares BERT's blocks and pipeline protocol (``models/bert.py``);
knowledge masking is a data-side strategy (whole-word and entity spans
arrive as ``mlm_labels``)."""
from __future__ import annotations

from dataclasses import dataclass

from .bert import BertConfig, BertForPretraining

__all__ = ["ErnieConfig", "ErnieForPretraining", "ernie_tiny"]


@dataclass
class ErnieConfig(BertConfig):
    vocab_size: int = 18000           # ERNIE zh vocab
    max_seq_len: int = 512
    type_vocab_size: int = 4          # ERNIE uses more segment types

    @staticmethod
    def ernie_base():
        return ErnieConfig()

    @staticmethod
    def ernie_large():
        return ErnieConfig(hidden_size=1024, num_layers=24, num_heads=16)

    @staticmethod
    def ernie_10b_style():
        """ERNIE-3.0-style dense trunk (the BASELINE.md ZeRO-3 config)."""
        return ErnieConfig(hidden_size=4096, num_layers=48, num_heads=64,
                           vocab_size=40000)


class ErnieForPretraining(BertForPretraining):
    """ERNIE's pretraining trunk and heads: ``BertForPretraining`` over
    an ``ErnieConfig``."""


def ernie_tiny(device=None, **kw):
    """Small config for tests."""
    cfg = ErnieConfig(vocab_size=128, hidden_size=64, num_layers=4,
                      num_heads=4, max_seq_len=64, **kw)
    return ErnieForPretraining(cfg, device=device)
