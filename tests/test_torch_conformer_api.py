"""The Conformer's ``output_layer_idx`` and ``return_attn`` and the t2s
model's ``extract_features`` against edm_tts_tpu's, on the CPU in f32.

A Conformer of depth 3, dim 32, heads 4 x 8 and the tiny t2s of
torch_port_parity (heads 2 x 12 inside a width of 32) take seeded numpy
weights through the JAX package's converters; a key mask has one short row
(13 of 19 positions valid). Hidden states and the per-layer attention maps
``(B, H, T, T)`` agree within 1e-5 (absolute and relative), at every
position: both sides attend over the valid keys only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tts_tpu.models.conformer import Conformer as JConformer
from edm_tts_tpu.models.conformer import ConformerConfig as JConformerConfig
from edm_tts_tpu.models.conformer.convert import conformer_to_torch
from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models.conformer import Conformer, ConformerConfig
from edm_tts_tpu_torch.ops import rope_frequencies
from torch_port_parity import random_variables, t2s_pair

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(dim=32, depth=3, dim_head=8, heads=4, ff_mult=4, conv_kernel_size=5)
B, T, VALID = 2, 19, (13, 19)


@pytest.fixture(scope="module")
def models():
    jconf = JConformer(JConformerConfig(**CFG))
    variables = random_variables(lambda r: jconf.init(r, jnp.zeros((1, 8, 32))), seed=5)
    sd: dict = {}
    conformer_to_torch(sd, variables["params"], "conformer", CFG["depth"])
    conf = Conformer(ConformerConfig(**CFG))
    load_reference_state_dict(conf, {k[len("conformer."):]: v for k, v in sd.items()})
    return {"conformer": (jconf, variables, conf), "t2s": t2s_pair(seed=2)}


@pytest.mark.parametrize("model,output_layer_idx,return_attn,masked", [
    ("conformer", 0, False, True),
    ("conformer", 1, False, True),
    ("conformer", None, False, True),
    ("conformer", None, True, True),
    ("conformer", 1, True, False),
    ("t2s", None, False, False),
    ("t2s", None, False, True),
    ("t2s", 0, True, True),
])
def test_conformer_api_matches_jax(models, model, output_layer_idx, return_attn, masked):
    jmodel, variables, port = models[model]
    rng = np.random.default_rng(7)
    mask = np.arange(T)[None, :] < np.array(VALID)[:, None] if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    kw = dict(output_layer_idx=output_layer_idx, return_attn=return_attn)
    if model == "conformer":
        x = rng.standard_normal((B, T, CFG["dim"])).astype(np.float32)
        ref = jmodel.apply(variables, jnp.asarray(x), mask=jmask, **kw)
        with torch.no_grad():
            out = port(torch.from_numpy(x), mask=tmask, **kw)
    else:
        ids = rng.integers(1, port.cfg.total_num_tokens, (B, T))
        if mask is not None:
            ids = np.where(mask, ids, 0)
        ref = jmodel.apply(variables, jnp.asarray(ids, jnp.int32), jmask, method="extract_features",
                           **kw)
        with torch.no_grad():
            out = port.extract_features(torch.from_numpy(ids), tmask, **kw)
    if return_attn:
        (out, maps), (ref, ref_maps) = out, ref
        depth = port.cfg.depth if model == "conformer" else port.cfg.main_encoder_num_layers
        want = depth if output_layer_idx is None else output_layer_idx + 1
        heads = CFG["heads"] if model == "conformer" else port.cfg.main_encoder_num_heads
        assert len(maps) == len(ref_maps) == want
        for m, r in zip(maps, ref_maps):
            assert m.dtype == torch.float32 and tuple(m.shape) == (B, heads, T, T)
            np.testing.assert_allclose(m.numpy(), np.asarray(r), **TOL)
            if mask is not None:  # no weight on a masked key
                assert float(m[0, :, :, VALID[0]:].abs().max()) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_output_layer_idx_runs_no_later_block(models):
    """The early exit is block i's output of the full forward, and blocks
    after i never run."""
    _, _, port = models["conformer"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, T, 32)).astype(np.float32))
    ran = []
    hooks = [blk.register_forward_hook(lambda m, a, o, i=i: ran.append(i))
             for i, blk in enumerate(port.layers)]
    try:
        with torch.no_grad():
            early = port(x, output_layer_idx=1)
            assert ran == [0, 1]
            ran.clear()
            full, _ = port(x, return_attn=True)
            assert ran == [0, 1, 2]
            by_hand = x
            for blk in port.layers[:2]:
                by_hand = blk(by_hand, rope=rope_frequencies(T, CFG["dim_head"]))
    finally:
        for h in hooks:
            h.remove()
    torch.testing.assert_close(early, by_hand, rtol=0, atol=0)
    assert not torch.equal(early, full)
