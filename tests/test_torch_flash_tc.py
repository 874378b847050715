"""The tensor-core route of paddle_tpu_torch's flash attention, held on
the CPU.

The CUDA kernels (``csrc/flash_attention_fwd_tc.cu`` and the backward's
``csrc/flash_attention_bwd_{single_tile,dq,dkv}_tc.cu``) run only on the
card, where chip_smoke.py holds them against their plain versions. Here
(the bf16 backward is held in ``tests/test_torch_flash_bwd_tc.py``):

- the route rule: bf16 at head dim 64 or 128 takes the tensor-core
  kernels, f32 and any other head dim the SIMT ones;
- the port's plain forward on bf16 inputs against the reference's Pallas
  forward in interpret mode on the same bf16 values, causal and full, at
  S 256 and D 64. Both outputs are bf16 and the two round at different
  points: the plain version rounds its logits to bf16 (a bf16 product)
  and rounds the normalised P, the reference keeps f32 logits and rounds
  the unnormalised P. Held at atol = rtol = 2e-2 (one bf16 ulp at
  |o| <~ 1, plus the logit rounding of 2^-9 |s|); the LSE at 2e-2 (f32
  on both sides of the bf16-rounded logits);
- the CPU path counts no launch of either route;
- every ``csrc/*.cu`` is built (listed in ``_build.SOURCES``) and names,
  in its header, the ``paddle_tpu/ops`` kernel it replaces.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parent.parent
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, False), (torch.bfloat16, 96, False),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.float16, 128, False)])
def test_route_rule(dtype, d, tc):
    assert tfa._tc_route(dtype, d) is tc


def _bf16_qkv(seed, b=2, s=256, h=2, d=64):
    """bf16 q/k/v as torch tensors and as the same values in JAX."""
    r = np.random.RandomState(seed)
    ts = [torch.from_numpy(r.randn(b, s, h, d).astype(np.float32))
          .bfloat16() for _ in range(3)]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts]
    return ts, js


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_bf16_matches_pallas_interpret(causal):
    (q, k, v), (jq, jk, jv) = _bf16_qkv(11)
    o_ref, res = jfa._flash_fwd_res(jq, jk, jv, causal, None)
    assert o_ref.dtype == jnp.bfloat16
    with torch.inference_mode():
        o, lse = tfa.flash_attention(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref.astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), **BF16_TOL)


def test_cpu_bf16_counts_no_launch():
    counters = ("FLASH_FWD_LAUNCHES", "FLASH_FWD_TC_LAUNCHES",
                "FLASH_BWD_SINGLE_LAUNCHES", "FLASH_BWD_SINGLE_TC_LAUNCHES",
                "FLASH_BWD_DQ_LAUNCHES", "FLASH_BWD_DQ_TC_LAUNCHES",
                "FLASH_BWD_DKV_LAUNCHES", "FLASH_BWD_DKV_TC_LAUNCHES")
    before = [getattr(tfa, c) for c in counters]
    (q, k, v), _ = _bf16_qkv(12, s=128)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, _ = tfa.flash_attention(q, k, v, causal=True)
    o.float().sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert [getattr(tfa, c) for c in counters] == before


def _header(path):
    lines = []
    for ln in path.read_text().splitlines():
        if not ln.startswith("//"):
            break
        lines.append(ln[2:])
    return " ".join(lines)


@pytest.mark.parametrize("src", sorted(p.name for p in _build.CSRC.glob("*.cu")))
def test_every_kernel_source_is_built_and_names_its_tpu_kernel(src):
    path = _build.CSRC / src
    assert path.stem in _build.SOURCES
    head = _header(path)
    files = set(re.findall(r"paddle_tpu/ops/(\w+)\.py", head))
    assert files, f"{src} names no paddle_tpu/ops file"
    kernels = set(re.findall(r"\b(_\w*kernel)\b", head))
    found = []
    for f in files:
        ref = (REPO / "paddle_tpu" / "ops" / f"{f}.py").read_text()
        assert "pallas_call" in ref
        found += [k for k in kernels if re.search(rf"^def {k}\(", ref, re.M)]
    assert found, f"{src} names no TPU kernel of {sorted(files)}"


def test_build_lists_only_existing_sources():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
