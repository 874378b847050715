"""Tensor-parallel layers at degree 1 (mirrors
``paddle_tpu/distributed/parallel_layers.py``).

They keep the reference's class and parameter names so that ``GPT`` reads
like the reference and its ``state_dict`` keys match. At degree 1 each is
exactly its dense counterpart; sharding over a ``torch.distributed`` mesh
comes with the distributed slice.
"""
from __future__ import annotations

from ..nn.layer.common import Embedding, Linear


class ColumnParallelLinear(Linear):
    """``W [in, out]`` (sharded on ``out`` once tensor parallelism lands)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, device=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias, device=device)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    """``W [in, out]`` (sharded on ``in`` once tensor parallelism lands)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, device=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias, device=device)


class VocabParallelEmbedding(Embedding):
    """Embedding table (sharded over vocab once tensor parallelism lands)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 device=None):
        super().__init__(num_embeddings, embedding_dim,
                         weight_attr=weight_attr, device=device)
