"""K6's plain versions (``ops.attn_variants``) against the Pallas kernel of
scripts/profile_attn_variants.py, on the CPU.

The script cannot be imported: its module body runs the benchmark. Its
``NEG_INF``, ``make_kernel`` and ``attn`` are taken from its source with
``ast`` and run with ``pl.pallas_call`` in interpret mode, and the kernel
body ``make_kernel`` also op by op outside ``jit``. Tolerance: a relative
l2 error of 1e-5 on f32 inputs (the same arithmetic in another summation
order) and 2^-6 on bf16 inputs (the two round p and the output to bf16 at
the same points, but sum in other orders). One exception: under ``jit`` on
the CPU, XLA's excess precision (``xla_allow_excess_precision``, on by
default) drops ``bf16exp``'s rounding of ``s - rowmax`` to bf16 inside the
fused kernel, so with f32 inputs that variant is held to 1e-5 against the
kernel body run op by op (what its source says) and to 2^-6 against the
jitted kernel.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from edm_tts_tpu_torch.kernels import launches, reset_launches
from edm_tts_tpu_torch.ops.attn_variants import (
    BLOCK_Q,
    VARIANTS,
    attn_variant,
    attn_variant_reference,
)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "profile_attn_variants.py"


@pytest.fixture(scope="module")
def pallas_attn():
    """The script's ``attn`` with ``pl.pallas_call`` in interpret mode."""
    tree = ast.parse(SCRIPT.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in ("make_kernel", "attn"))
            or (isinstance(n, ast.Assign) and any(getattr(t, "id", None) == "NEG_INF"
                                                  for t in n.targets))]
    assert len(keep) == 3
    interp = type("pl", (), {"pallas_call": staticmethod(
        functools.partial(pl.pallas_call, interpret=True)), "BlockSpec": pl.BlockSpec})
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "np": np, "pl": interp}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns["attn"]


def _eager_kernel(q, k, v, variant):
    """``make_kernel``'s body op by op on each (batch, head), no ``jit``."""
    class Ref:
        def __init__(self, a):
            self.a, self.dtype = a, a.dtype

        def __getitem__(self, i):
            return self.a[i]

        def __setitem__(self, i, val):
            self.a = val[None]

    tree = ast.parse(SCRIPT.read_text())
    ns = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=[n for n in tree.body if getattr(n, "name", "") == "make_kernel"],
                            type_ignores=[]), str(SCRIPT), "exec"), ns)
    kernel = ns["make_kernel"](variant, q.shape[-1] ** -0.5)
    out = np.zeros(q.shape, np.float32)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            o = Ref(jnp.zeros((1,) + q.shape[1:2] + q.shape[3:], jnp.float32))
            kernel(*(Ref(jnp.asarray(x[b:b + 1, :, h])) for x in (q, k, v)), o)
            out[b, :, h] = np.asarray(o.a[0])
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b,t,h,d,block_q", [(2, 40, 3, 24, 16), (1, 64, 2, 8, 64)])
def test_plain_variants_match_the_pallas_kernel(pallas_attn, variant, b, t, h, d, block_q):
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5),
                               (torch.bfloat16, jnp.bfloat16, 2.0 ** -6)):
        tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
        port = attn_variant_reference(tq, tk, tv, variant=variant).float().numpy()
        jq, jk, jv = (jnp.asarray(x, jdtype) for x in (q, k, v))
        ref = np.asarray(pallas_attn(jq, jk, jv, variant=variant, block_q=block_q)
                         .astype(jnp.float32))
        assert port.shape == ref.shape == (b, t, h, d)
        if variant == "bf16exp" and dtype == torch.float32:
            eager = _eager_kernel(q, k, v, variant)
            assert _rel(port, eager) <= tol, (variant, dtype, _rel(port, eager))
            tol = 2.0 ** -6
        assert _rel(port, ref) <= tol, (variant, dtype, _rel(port, ref))


def test_variants_differ_and_the_wrapper_checks_its_arguments():
    """The four variants are four functions (bf16exp differs from full by
    its bf16 rounding only, every other pair by more than 10 %); the CPU
    wrapper takes the plain version, counts nothing,
    and rejects an unknown variant or query tile."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 30, 2, 24)).astype(np.float32))
               for _ in range(3))
    reset_launches()
    outs = {name: attn_variant(q, k, v, variant=name, block_q=BLOCK_Q[-1]) for name in VARIANTS}
    assert launches["attn_variants"] == 0
    for name, out in outs.items():
        torch.testing.assert_close(out, attn_variant_reference(q, k, v, variant=name),
                                   rtol=0, atol=0)
    names = list(VARIANTS)
    for i, a in enumerate(names):
        for bname in names[i + 1:]:
            if {a, bname} == {"full", "bf16exp"}:
                assert 1e-4 < _rel(outs[a], outs[bname]) < 2.0 ** -6
            else:
                assert _rel(outs[a], outs[bname]) > 0.1, (a, bname)
    # full is softmax attention
    sm = torch.softmax(torch.einsum("bihd,bjhd->bhij", q, k) * 24 ** -0.5, dim=-1)
    torch.testing.assert_close(outs["full"], torch.einsum("bhij,bjhd->bihd", sm, v),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="variant"):
        attn_variant(q, k, v, variant="fast")
    with pytest.raises(ValueError, match="block_q"):
        attn_variant(q, k, v, block_q=256)
