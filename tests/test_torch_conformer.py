"""The port's Conformer against edm_tts_tpu's, with a key mask and
``conv_pad_mask``, at heads x dim_head (2 x 12) != hidden (32).

Weights cross over through the JAX package's conformer converter
(``conformer_to_torch``) and the port's strict loader. f32 on the CPU,
atol/rtol 1e-4.
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
from torch_port_parity import random_variables

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(dim=32, depth=2, dim_head=12, heads=2, ff_mult=4, conv_kernel_size=5)


@pytest.fixture(scope="module")
def conformers():
    jmodel = JConformer(JConformerConfig(**CFG))
    variables = random_variables(lambda r: jmodel.init(r, jnp.zeros((1, 8, 32))), seed=3)
    sd: dict = {}
    conformer_to_torch(sd, variables["params"], "conformer", CFG["depth"])
    model = Conformer(ConformerConfig(**CFG))
    load_reference_state_dict(model, {k[len("conformer."):]: v for k, v in sd.items()})
    return jmodel, variables, model


@pytest.mark.parametrize("masked", [False, True])
def test_conformer_matches_jax(conformers, masked):
    jmodel, variables, model = conformers
    rng = np.random.default_rng(int(masked))
    x = rng.standard_normal((2, 19, 32)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(19)[None, :] < np.array([[13], [19]])
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jmodel.apply(variables, jnp.asarray(x), mask=jmask, conv_pad_mask=jmask)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        out = model(torch.from_numpy(x), mask=tmask, conv_pad_mask=tmask).numpy()
    if masked:  # padded positions are garbage on both sides; compare valid ones
        out, ref = out[mask], np.asarray(ref)[mask]
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
