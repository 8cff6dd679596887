"""Pipeline-parallel training forward of the s2a injection Conformer (port
of edm_tts_tpu/models/s2a/pipeline.py).

The 16-block injection walk of ``InjectionConformer.forward_teacher_logits``
runs through the GPipe executor (parallel/pipeline.py): the blocks split
into S stages, the microbatches streamed through them.

- **Teacher injections at inner layers** (4, 7, 10, 13): their projections
  do not depend on the blocks, so they are computed outside the pipe (the
  projection weights still get their gradient) and reach each stage as
  side inputs; they never hop.
- **Which layer injects**: each stage knows its global layer ids, so the
  branch is plain Python (JAX's per-layer tables and predicated adds serve
  its one SPMD program).
- **The coarse outputs** (each injection layer's output before the
  injection) feed the logits head after the last stage, so a ``(mb, Qc, T,
  H)`` buffer hops with the activation.
- **The residual re-add** (the injection plus the previous injection
  layer's coarse output) reads that buffer at idx - 1.

As JAX's, the blocks run without dropout and without a pad mask (the
training forward's own quirk). The front (``prepare_train_inputs``) and the
loss's targets are ``model.py``'s, which ``forward_train`` uses too.
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.models.conformer.conformer import apply_block
from edm_tts_tpu_torch.models.s2a.model import prepare_train_inputs, train_targets
from edm_tts_tpu_torch.ops import rope_frequencies
from edm_tts_tpu_torch.ops.embedding import masked_nll
from edm_tts_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce, sum_parts
from edm_tts_tpu_torch.parallel.pipeline import PipelinePlan, micro_rows, pipeline_apply


def pipelined_forward_logits(model, enc_in: torch.Tensor, teacher: torch.Tensor, mesh, *,
                             n_micro: int) -> torch.Tensor:
    """``forward_teacher_logits(enc_in, teacher)`` without dropout, ``(B, Q,
    T, N)``, as a GPipe pipeline over ``mesh``'s pipe axis in ``n_micro``
    microbatches. ``enc_in`` and ``teacher`` hold this rank's rows
    (``micro_rows`` under a data axis); the blocks of this process's stages
    must be in the model (``split_stages`` keeps just those). The head runs
    on the outputs the pipe returns on every rank."""
    cfg = model.cfg
    plan = PipelinePlan(mesh, cfg.encoder_num_layers)
    if not (cfg.use_injection and cfg.residual):
        raise ValueError("pipelined_forward_logits implements the use_injection + residual "
                         "walk")
    b, t, h = enc_in.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    mb = b // n_micro
    inj_layers = tuple(cfg.injection_layers)
    qc = len(inj_layers)
    proj = torch.stack([model.encoder.project_injection[i](teacher[i].to(model.dtype))
                        for i in range(qc)], dim=1)  # (B, Qc, T, H)
    rope = rope_frequencies(t, cfg.encoder_config.dim_head, device=enc_in.device)
    layers = model.encoder.layers

    def stage_fn(stage, act, side):
        x, coarse = act["x"], act["coarse"]
        for g in plan.layers(stage):
            cur = apply_block(layers[g], x, cfg.encoder_config, rope=rope)
            if g in inj_layers:
                idx = inj_layers.index(g)
                residual = coarse[:, idx - 1] if idx else None
                coarse = coarse.index_copy(
                    1, torch.tensor([idx], device=cur.device), cur[:, None].to(coarse.dtype))
                cur = cur + side["inj"][:, idx]
                if residual is not None:
                    cur = cur + residual
            x = cur
        return {"x": x, "coarse": coarse}

    micro = {"x": enc_in.reshape(n_micro, mb, t, h),
             "coarse": enc_in.new_zeros((n_micro, mb, qc, t, h))}
    out = pipeline_apply(stage_fn, micro, mesh,
                         side_inputs={"inj": proj.reshape(n_micro, mb, qc, t, h)})
    final = out["x"].reshape(b, t, h)
    coarse = out["coarse"].reshape(b, qc, t, h)
    return model._all_level_logits(final, list(coarse.unbind(1)))


def pipelined_train_loss(model, acoustic_tokens: torch.Tensor, semantic_tokens: torch.Tensor,
                         mask: torch.Tensor, mesh, *, n_micro: int) -> torch.Tensor:
    """The loss of ``forward_train(acoustic_tokens, semantic_tokens,
    mask_override=mask, train=False)`` on the global batch, through the pipe:
    this rank takes its rows of every microbatch, and the masked sums are
    reduced over the data ranks, so every rank returns the global loss.
    After its backward, ``parallel.pipeline.reduce_gradients(model, mesh)``
    sums the gradients over data."""
    rows = micro_rows(semantic_tokens.shape[0], n_micro, mesh).to(semantic_tokens.device)
    ac, sem, mask = acoustic_tokens[rows], semantic_tokens[rows], mask[rows]
    enc_in, teacher = prepare_train_inputs(model, ac, sem, mask)
    logits = pipelined_forward_logits(model, enc_in, teacher, mesh, n_micro=n_micro)
    total, count = masked_nll(logits, *train_targets(model.cfg, ac, mask))
    group = mesh.group(DATA_AXIS)
    return sum_parts(total, group) / all_reduce(count, group).clamp_min(1.0)
