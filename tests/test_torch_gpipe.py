"""GPipe pipeline parallelism of the port (``parallel/pipeline.py``,
``models/s2a/pipeline.py``) on gloo ranks, against the port's one-process
path and against the JAX package's pipelines.

Two spawns (tests/torch_dist_workers.py ``scenario_gpipe4`` on 4 ranks and
``scenario_gpipe8`` on 8), started together; while they run, this process
computes the references: the port's one-process path and the JAX
``pipelined_forward_logits`` on the conftest's virtual CPU devices with
each layout's mesh (``make_pipe_mesh(n_pipe, n_data, n_model)``,
``micro_spec=P(None, "data")`` over data, ``auto={"model"}`` over model).

- The executor on a stack of 4 tiny Conformer blocks (mirroring JAX
  tests/test_pipeline_parallel.py): the output at pipe 4, pipe 2 and pipe
  2 x data 2 equals the sequential stack's, and pipe 4's whole gradient
  equals the stack's; int ids beyond f32's integers and bools come back
  exact, with the feed's gradient on every rank.
- The s2a walk (mirroring JAX tests/test_s2a_pipeline_parallel.py) on the
  tiny s2a of ``s2a_pair`` (4 blocks, injections at 1 and 2), B4 x 12 in 2
  microbatches, on pipe 4, pipe 2, pipe 2 x data 2, pipe 2 x model 2, pipe 4
  x data 2, pipe 4 x model 2 and pipe 2 x data 2 x model 2: each rank's
  logits (its rows of every microbatch), the global loss and the whole
  gradients (gathered over model, then pipe) against ``forward_train(...,
  mask_override=mask, train=False)`` (logits atol 2e-5, loss rtol 1e-6,
  gradients ``GRAD_TOL``) and against JAX on the same weights (logits
  atol/rtol 1e-4, loss rtol 1e-5, gradients ``GRAD_TOL``).
- Each rank holds only its stage's blocks; a local pipe 4 (all stages in
  one process, how one card runs them) equals the 4-rank result within
  1e-6; the raises of JAX's (depth % S, batch % M, no injection).
- The 8-rank spawn also runs every leg of ``dryrun_multichip`` (gloo),
  leg 5's loss within 1e-4 of leg 3's.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from edm_tts_tpu.models.s2a.convert import to_torch_state_dict as s2a_to_torch
from edm_tts_tpu.models.s2a.pipeline import pipelined_forward_logits as j_pipelined_logits
from edm_tts_tpu.models.s2a.pipeline import prepare_train_inputs as j_prepare
from edm_tts_tpu.ops.embedding import masked_cross_entropy as j_masked_ce
from edm_tts_tpu.parallel.pipeline import make_pipe_mesh as j_make_pipe_mesh
from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import CodecConfig
from edm_tts_tpu_torch.models.conformer.conformer import Conformer, ConformerConfig
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
from edm_tts_tpu_torch.models.s2a.pipeline import pipelined_forward_logits, prepare_train_inputs
from edm_tts_tpu_torch.ops import rope_frequencies
from edm_tts_tpu_torch.parallel.mesh import make_pipe_mesh
from test_torch_s2a_train import GRAD_TOL
from torch_dist_workers import GPIPE4, GPIPE8, start
from torch_port_parity import TINY_CODEC, TINY_S2A, s2a_pair

B, Q, T, M = 4, 4, 12, 2  # batch, levels, frames, microbatches
LAYOUTS = {**GPIPE4, **GPIPE8}
LOGIT_ATOL, LOSS_RTOL = 2e-5, 1e-6
JAX_TOL, JAX_LOSS_RTOL = dict(atol=1e-4, rtol=1e-4), 1e-5
LOCAL_ATOL = 1e-6
STACK = ConformerConfig(dim=16, depth=4, dim_head=8, heads=2, conv_kernel_size=7)


def _jax_lower(jmodel, variables, batch, shape):
    """JAX's pipelined loss and gradients (logits beside) on a (pipe, data,
    model) mesh of the virtual devices, lowered for ``variables``."""
    n_pipe, n_data, n_model = shape
    mesh = j_make_pipe_mesh(n_pipe, n_data=n_data, n_model=n_model,
                            devices=jax.devices()[:n_pipe * n_data * n_model])
    spec = P(None, "data") if n_data > 1 else P()
    auto = frozenset({"model"}) if n_model > 1 else frozenset()
    ac, sem, mask = (jnp.asarray(batch[k]) for k in ("ac", "sem", "mask"))

    def loss(params):
        p = {"params": params}
        enc_in, teacher = j_prepare(jmodel, p, ac, sem, mask)
        logits = j_pipelined_logits(jmodel, p, enc_in, teacher, mesh, n_micro=M,
                                    micro_spec=spec, auto=auto)
        targets = ac.astype(jnp.int32)
        loss_mask = jnp.broadcast_to(mask[:, None, :], targets.shape)
        return j_masked_ce(logits, targets, loss_mask), logits

    return jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(variables["params"])


def _jax_run(lowered, jmodel, variables):
    """Compile (XLA's quick backend: the compiles dominate this file's
    time) and run; the gradients by torch name, the frozen codec left out."""
    compiled = lowered.compile({"xla_backend_optimization_level": 0})
    (value, logits), grads = compiled(variables["params"])
    grads = {**grads, "codec": variables["params"]["codec"]}
    grads = {k: v for k, v in s2a_to_torch(jmodel.cfg, {"params": grads}).items()
             if not k.startswith("acoustic_model.")}
    return {"loss": float(value), "logits": np.asarray(logits), "grads": grads}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jmodel, variables, model = s2a_pair(seed=3)
    rng = np.random.default_rng(5)
    batch = {"ac": rng.integers(0, 16, (B, Q, T)).astype(np.int32),
             "sem": rng.integers(0, 8, (B, T)).astype(np.int32),
             "mask": rng.random((B, T)) < 0.5}
    stack = Conformer(STACK)
    init_random_weights(stack, 1)
    x = rng.standard_normal((4, 2, T, STACK.dim)).astype(np.float32)
    joins = []
    for scenario, world in (("gpipe4", 4), ("gpipe8", 8)):
        tmp = tmp_path_factory.mktemp(scenario)
        torch.save(dict(s2a=model, batch=batch, stack=stack, x=x), tmp / "inputs.pt")
        joins.append(start(scenario, world, tmp))

    # while the ranks run: JAX on every layout, then the one-process references
    # (tracing holds the GIL; XLA's compiles and runs go in parallel threads)
    lowered = [_jax_lower(jmodel, variables, batch, shape) for shape in LAYOUTS.values()]
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        jax_runs = dict(zip(LAYOUTS, pool.map(lambda low: _jax_run(low, jmodel, variables),
                                              lowered)))
    ac, sem, mask = (torch.as_tensor(batch[k]) for k in ("ac", "sem", "mask"))
    out = model.forward_train(ac, sem, mask_override=mask, train=False)
    out["loss"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    with torch.no_grad():
        logits = model.forward_teacher_logits(*prepare_train_inputs(model, ac, sem, mask))
    xs = torch.as_tensor(x).reshape(-1, T, STACK.dim)
    rope = rope_frequencies(T, STACK.dim_head)
    y = xs
    for block in stack.layers:
        y = block(y, rope=rope)
    y.square().mean().backward()
    r4, r8 = (join() for join in joins)
    return dict(jax=jax_runs, r4=r4, r8=r8, loss=out["loss"].item(), grads=grads,
                logits=logits, stack=stack, stack_y=y.detach().reshape(x.shape))


def _ranks(run, key):
    """The results of ``key`` on the ranks that took part in it."""
    found = [r[key] for r in run["r4" if key in GPIPE4 or key == "pipe4_local" else "r8"]
             if r[key] is not None]
    assert found
    return found


# -- the executor on a Conformer stack ----------------------------------------------
@pytest.mark.parametrize("key,ranks", [("stack4", 4), ("stack2", 2), ("stack2_data2", 4)])
def test_executor_matches_the_sequential_stack(run, key, ranks):
    outs = [r[key] for r in run["r4"] if r[key] is not None]
    assert len(outs) == ranks
    ref = run["stack_y"].reshape(-1, T, STACK.dim)
    for o in outs:
        want = ref[o["rows"]].reshape(o["y"].shape)
        np.testing.assert_allclose(o["y"].numpy(), want.numpy(), atol=LOGIT_ATOL)


def test_executor_gradients_match_the_sequential_stack(run):
    for o in (r["stack4"] for r in run["r4"]):
        assert o["grads"].keys() == dict(run["stack"].named_parameters()).keys()
        for n, p in run["stack"].named_parameters():
            np.testing.assert_allclose(o["grads"][n].numpy(), p.grad.numpy(), err_msg=n,
                                       **GRAD_TOL)


def test_passthrough_fields_come_back_intact(run):
    outs = [r["passthrough"] for r in run["r4"] if r["passthrough"] is not None]
    assert len(outs) == 2
    x = torch.arange(6.0).reshape(3, 2)
    for o in outs:
        assert torch.equal(o["x"], (x * 2 + 1) * 3 + 1)
        assert torch.equal(o["m"], torch.ones(3, 2))
        assert o["ids"].dtype == torch.int32 and o["ids"][0].tolist() == [2 ** 24 + 1, 2 ** 30 - 3]
        assert o["flag"].dtype == torch.bool and o["flag"].tolist() == [[True, False]] * 3
        assert torch.equal(o["dx"], torch.full((3, 2), 6.0))  # the feed's gradient on every rank


# -- the s2a walk ---------------------------------------------------------------------
@pytest.mark.parametrize("key", list(LAYOUTS))
def test_s2a_pipeline_matches_one_process(run, key):
    for o in _ranks(run, key):
        assert o["loss"] == pytest.approx(run["loss"], rel=LOSS_RTOL)
        np.testing.assert_allclose(o["logits"].numpy(), run["logits"][o["rows"]].numpy(),
                                   atol=LOGIT_ATOL)
        assert o["grads"].keys() == run["grads"].keys()
        for n, g in run["grads"].items():
            np.testing.assert_allclose(o["grads"][n].numpy(), g.numpy(), err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("key", list(LAYOUTS))
def test_s2a_pipeline_matches_jax(run, key):
    ref = run["jax"][key]
    for o in _ranks(run, key):
        assert o["loss"] == pytest.approx(ref["loss"], rel=JAX_LOSS_RTOL)
        np.testing.assert_allclose(o["logits"].numpy(), ref["logits"][o["rows"].numpy()],
                                   **JAX_TOL)
        assert o["grads"].keys() == ref["grads"].keys()
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(o["grads"][n].numpy(), g, err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("key", ["pipe4", "pipe2", "pipe4_model2"])
def test_each_rank_holds_only_its_stage(run, key):
    n_pipe = LAYOUTS[key][0]
    per = TINY_S2A["encoder_num_layers"] // n_pipe
    runs = [r[key] for r in run["r4" if key in GPIPE4 else "r8"]]
    for rank, o in enumerate(runs[:n_pipe * LAYOUTS[key][1] * LAYOUTS[key][2]]):
        stage = rank // (LAYOUTS[key][1] * LAYOUTS[key][2])
        held = {int(n.split(".")[2]) for n in o["names"] if n.startswith("encoder.layers.")}
        assert held == set(range(stage * per, (stage + 1) * per)), (rank, held)
        assert any(n.startswith("encoder.to_logits") for n in o["names"])


def test_local_pipe_equals_the_ranks(run):
    ranks = run["r4"][0]["pipe4"]
    for r in run["r4"]:
        local = r["pipe4_local"]
        assert local["loss"] == pytest.approx(ranks["loss"], abs=LOCAL_ATOL)
        np.testing.assert_allclose(local["logits"].numpy(), ranks["logits"].numpy(),
                                   atol=LOCAL_ATOL)
        for n, g in ranks["grads"].items():
            np.testing.assert_allclose(local["grads"][n].numpy(), g.numpy(), atol=LOCAL_ATOL,
                                       err_msg=n)


def _tiny_model(**kw):
    model = InjectionConformer(S2AConfig(**{**TINY_S2A, **kw}, codec=CodecConfig(**TINY_CODEC)))
    init_random_weights(model, 0)
    return model


@pytest.mark.parametrize("case", ["depth", "batch", "no_injection"])
def test_raises_as_jax(case):
    model = _tiny_model(use_injection=case != "no_injection")
    enc_in, teacher = torch.zeros(B, T, 32), torch.zeros(2, B, T, TINY_CODEC["codebook_dim"])
    stages, n_micro = {"depth": (3, 2), "batch": (2, 3), "no_injection": (2, 2)}[case]
    with pytest.raises(ValueError):
        pipelined_forward_logits(model, enc_in, teacher, make_pipe_mesh(stages, local=True),
                                 n_micro=n_micro)


def test_dryrun_multichip_runs_every_leg(run):
    for r in run["r8"]:
        legs = r["dryrun"]
        assert set(legs) == {"dp", "sp", "pp", "dp_pp", "tp_pp"}
        assert all(np.isfinite(v) for v in legs.values())
        assert abs(legs["tp_pp"] - legs["pp"]) < 1e-4
    lines = run["r8"][0]["dryrun_lines"]
    assert len(lines) == 5 and all(" OK" in line for line in lines), lines
