"""Multi-device dry run of the port (counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``): one tiny s2a training step on
every layout the world allows.

    torchrun --nproc_per_node N -m edm_tts_tpu_torch.dryrun_multichip [--device cpu]

The default is the card and NCCL (one card a rank); ``--device cpu`` runs
gloo ranks on the CPU. Without torchrun's environment it is one process.
On the tiny s2a of ``tiny_s2a_config`` (8 blocks, hidden 128), f32, from
a seeded init and seeded tokens, it runs:

1. the full step (loss -> gradients -> ZeRO-2 AdamW) of the s2a
   ``Trainer`` over data x fsdp x model (fsdp 2 and model 2 when N is a
   multiple of 4, fsdp 2 when it is even), at any N;
2. with N >= 8, the same step with ring attention over data N/4 x
   sequence 4;
3. with N >= 4, the pipelined loss and gradients on a pipe of 4 stages
   (``models/s2a/pipeline.py``, 2 microbatches) on the first 4 ranks;
4. with N >= 8, the same on pipe 4 x data 2;
5. with N >= 8, the same on pipe 4 x model 2, whose loss must equal leg
   3's within 1e-4.

Legs 2-5 start from leg 1's updated weights, as JAX's do. Rank 0 prints
one line per leg; the run exits non-zero when a leg fails.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import shutil
import tempfile

import torch
import torch.distributed as dist

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import CodecConfig
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
from edm_tts_tpu_torch.models.s2a.pipeline import pipelined_train_loss
from edm_tts_tpu_torch.parallel import dist as pdist
from edm_tts_tpu_torch.parallel.mesh import MODEL_AXIS, make_pipe_mesh
from edm_tts_tpu_torch.parallel.pipeline import reduce_gradients, split_stages
from edm_tts_tpu_torch.parallel.tensor import tensor_parallel
from edm_tts_tpu_torch.train import run_s2a
from edm_tts_tpu_torch.train.optim import freeze_submodule
from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments

FRAMES = 32
N_MICRO = 2
TP_PP_LOSS_TOL = 1e-4  # leg 5 against leg 3, as the JAX dry run asserts


def tiny_s2a_config(**kw) -> S2AConfig:
    """The JAX dry run's tiny s2a (``__graft_entry__.py::_tiny_s2a_config``)."""
    codec = CodecConfig(encoder_dim=16, decoder_dim=128, n_codebooks=12, codebook_size=64,
                        codebook_dim=8, quantizer_dropout=0.0)
    return S2AConfig(hidden_size=128, num_semantic_tokens=64, encoder_num_heads=4,
                     encoder_num_layers=8, injection_layers=(2, 3, 4, 5),
                     encoder_attn_dropout=0.0, encoder_ff_dropout=0.0,
                     encoder_conv_dropout=0.0, codec=codec, **kw)


def _model(cfg: S2AConfig, device, seed: int) -> InjectionConformer:
    model = InjectionConformer(cfg, device=device)
    init_random_weights(model, seed)
    freeze_submodule(model, "acoustic_model")
    return model


def _tokens(cfg: S2AConfig, rows: int, device, seed: int) -> dict[str, torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    batch = {"acoustic_tokens": torch.randint(0, cfg.codec.codebook_size,
                                              (rows, cfg.num_quantizers, FRAMES), generator=gen),
             "semantic_tokens": torch.randint(0, cfg.num_semantic_tokens, (rows, FRAMES),
                                              generator=gen)}
    return {k: v.to(device) for k, v in batch.items()}


def _mask(rows: int, device, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((rows, FRAMES), generator=gen) < 0.6).to(device)


def _trainer_step(model, batch, out_dir: str, device, **layout) -> tuple[Trainer, float]:
    """One step of the s2a ``Trainer`` (f32; TF32 off on the card)."""
    args = TrainingArguments(output_dir=out_dir, per_device_train_batch_size=len(
        batch["semantic_tokens"]), max_steps=100, learning_rate=1e-4, warmup_steps=10,
        max_grad_norm=0.5, save_total_limit=None, **layout)
    _, loss_fn = run_s2a.s2a_loss(model, bf16=False)
    trainer = Trainer(args, model, loss_fn, device=device)
    with run_s2a.precision(False, device):
        metrics = trainer.train_step(batch, 0)
    return trainer, metrics["loss"].item()


def _pipe_leg(base, state, batch, mask, device, n_data: int = 1, n_model: int = 1):
    """The pipelined loss and gradients on pipe 4 (x data x model) over the
    first ranks: (loss, gradient tensors) on them, None on the others."""
    mesh = make_pipe_mesh(4, n_data=n_data, n_model=n_model)
    if mesh is None:
        return None
    model = copy.deepcopy(base)
    model.load_state_dict(state)
    split_stages(model.encoder.layers, mesh, "encoder.layers")
    if n_model > 1:
        tensor_parallel(model, mesh)
    with run_s2a.precision(False, device), torch.enable_grad():
        loss = pipelined_train_loss(model, batch["acoustic_tokens"], batch["semantic_tokens"],
                                    mask, mesh, n_micro=N_MICRO)
        loss.backward()
    reduce_gradients(model, mesh)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not all(torch.isfinite(g).all() for g in grads) or not torch.isfinite(loss):
        raise RuntimeError("the pipelined loss or a gradient is not finite")
    return loss.item(), len(grads)


def _from_rank0(value: float) -> float:
    """Rank 0's ``value`` on every rank."""
    if not pdist.is_distributed():
        return value
    x = torch.tensor([value], dtype=torch.float64, device=pdist.collective_device())
    dist.broadcast(x, 0)
    return x.item()


def run(device, *, seed: int = 0, log=print) -> dict:
    """Every leg the world allows (module docstring); returns their losses
    by leg (None where this rank took no part). ``device``: this rank's
    device (``parallel.dist.initialize``'s)."""
    rank, world = pdist.process_info()
    cfg = tiny_s2a_config()
    base = _model(cfg, device, seed)
    if world % 4 == 0:
        n_fsdp, n_model = 2, 2
    elif world % 2 == 0:
        n_fsdp, n_model = 2, 1
    else:
        n_fsdp, n_model = 1, 1
    n_data = world // (n_fsdp * n_model)
    batch = _tokens(cfg, 2 * n_data, device, seed + 1)
    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="dryrun_multichip_")
    try:
        # leg 1: the full step over data x fsdp x model with ZeRO-2
        trainer, out["dp"] = _trainer_step(copy.deepcopy(base), batch, f"{tmp}/dp", device,
                                           n_fsdp=n_fsdp, n_model=n_model)
        state = trainer.model_state()  # whole tensors (a collective)
        mesh = trainer.mesh.shape
        del trainer
        if rank == 0:
            log(f"dryrun_multichip OK: {world} devices (data={mesh['data']}, "
                f"fsdp={mesh['fsdp']}, model={mesh[MODEL_AXIS]}), loss={out['dp']:.4f}")

        # leg 2: ring attention over data x sequence 4
        if world >= 8:
            ring = _model(dataclasses.replace(cfg, attn_implementation="ring"), device, seed)
            ring.load_state_dict(state)
            _, out["sp"] = _trainer_step(ring, _tokens(cfg, world // 4, device, seed + 2),
                                         f"{tmp}/sp", device, n_seq=4)
            if rank == 0:
                log(f"dryrun sp OK: ring attention over (data={world // 4}, sequence=4) "
                    f"fwd+bwd+update, loss={out['sp']:.4f}")

        # leg 3: pipe 4
        mask = _mask(len(batch["semantic_tokens"]), device, seed + 3)
        if world >= 4:
            pp = _pipe_leg(base, state, batch, mask, device)
            out["pp"] = _from_rank0(pp[0] if pp else float("nan"))
            if rank == 0:
                log(f"dryrun pp OK: 4-stage GPipe fwd+bwd, loss={pp[0]:.4f}, {pp[1]} grad "
                    "tensors")
        if world >= 8:
            # leg 4: pipe 4 x data 2
            dpp = _pipe_leg(base, state, batch, _mask(len(mask), device, seed + 4), device,
                            n_data=2)
            out["dp_pp"] = dpp and dpp[0]
            if rank == 0:
                log(f"dryrun dp x pp OK: (pipe=4, data=2) GPipe fwd+bwd, loss={dpp[0]:.4f}, "
                    f"{dpp[1]} grad tensors")
            # leg 5: pipe 4 x model 2, on leg 3's inputs
            tpp = _pipe_leg(base, state, batch, mask, device, n_model=2)
            out["tp_pp"] = tpp and tpp[0]
            if tpp and abs(tpp[0] - out["pp"]) >= TP_PP_LOSS_TOL:
                raise RuntimeError(f"pipe 4 x model 2 loss {tpp[0]} != pipe 4 loss {out['pp']}")
            if rank == 0:
                log(f"dryrun tp x pp OK: (pipe=4, model=2) Megatron-in-pipe fwd+bwd, "
                    f"loss={tpp[0]:.4f} (== pp leg), {tpp[1]} grad tensors")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, the default) or cpu (gloo)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.exit(2, "no CUDA device; pass --device cpu to run on the CPU\n")
    device = pdist.initialize(args.device)
    try:
        run(device, seed=args.seed)
    finally:
        if pdist.is_distributed():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
