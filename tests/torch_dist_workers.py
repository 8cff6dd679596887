"""Multi-process checks of the port's multi-device layer on the CPU (gloo).

``spawn(scenario, world, tmp)`` starts ``world`` processes of this file, each
with ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT`` on a free port), so each joins the group
through ``parallel.dist.initialize("cpu")``. A worker reads its inputs from
``tmp/inputs.pt`` (written by the test before the spawn), runs every check
of its scenario and saves what it found to ``tmp/<scenario>_rank<r>.pt``;
the test asserts on those. The workers import torch and the port only (no
JAX), and are joined with a timeout: a hang fails the test instead of
running into the suite's time limit.
"""

from __future__ import annotations

import copy
import os
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, world: int, tmp, timeout: float = 300.0) -> list[dict]:
    """Run ``scenario`` on ``world`` gloo ranks; returns each rank's results."""
    return start(scenario, world, tmp, timeout)()


def start(scenario: str, world: int, tmp, timeout: float = 300.0):
    """Start ``scenario`` on ``world`` gloo ranks and return the function
    that joins them (``spawn``'s second half), so the test can work while
    they run."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        env.pop("JAX_PLATFORMS", None)
        # output to a file: a pipe that nobody reads while the test works
        # would stall a worker once it fills
        with open(os.path.join(str(tmp), f"{scenario}_rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, __file__, scenario, str(tmp)],
                                          env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    return lambda: _join(scenario, world, tmp, timeout, procs, deadline)


def _join(scenario, world, tmp, timeout, procs, deadline) -> list[dict]:
    outs = []
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            with open(os.path.join(str(tmp), f"{scenario}_rank{rank}.log")) as log:
                outs.append(log.read())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{scenario}: the {world} workers did not finish in "
                                 f"{timeout} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{scenario} rank {rank} failed:\n{out[-6000:]}"
    return [torch.load(os.path.join(str(tmp), f"{scenario}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- helpers shared by the scenarios and the tests ------------------------------
LOOP = dict(learning_rate=1e-2, warmup_steps=1, max_grad_norm=0.05, logging_steps=1,
            save_steps=1000, adam_beta1=0.8, adam_beta2=0.99)


def trainable(model) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def s2a_trainer(model, out_dir, *, steps: int, batch: int, mesh=None, **kw):
    """The s2a ``Trainer`` of ``run_s2a`` at f32 on the CPU (loss weighted by
    the masked count; a batch's ``"mask"`` replaces the drawn one)."""
    from edm_tts_tpu_torch.train import run_s2a
    from edm_tts_tpu_torch.train.optim import freeze_submodule
    from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments

    freeze_submodule(model, "acoustic_model")
    args = TrainingArguments(output_dir=str(out_dir), per_device_train_batch_size=batch,
                             max_steps=steps, **{**LOOP, "save_total_limit": None, **kw})
    _, loss_fn = run_s2a.s2a_loss(model, bf16=False)
    return Trainer(args, model, loss_fn, device="cpu", mesh=mesh)


def t2s_trainer(model, out_dir, *, steps: int, batch: int, **kw):
    from edm_tts_tpu_torch.train import run_t2s
    from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments

    args = TrainingArguments(output_dir=str(out_dir), per_device_train_batch_size=batch,
                             max_steps=steps, **{**LOOP, **kw})
    _, loss_fn = run_t2s.t2s_loss(model, bf16=False)
    return Trainer(args, model, loss_fn, device="cpu")


def gan_trainer(codec, disc, out_dir, *, steps: int, mesh=None, **kw):
    from edm_tts_tpu_torch.models.codec.losses import ReconstructionLoss
    from edm_tts_tpu_torch.train.gan_trainer import GANTrainer, GANTrainingArguments

    args = GANTrainingArguments(output_dir=str(out_dir), max_steps=steps, logging_steps=1,
                                eval_steps=1000, save_steps=1000, **kw)
    recon = ReconstructionLoss(16000, mel_spectrogram_args={
        "n_mels": (5,), "window_lengths": (64,), "mel_fmin": (0.0,), "mel_fmax": (None,)})
    return GANTrainer(args, codec, disc, recon, device="cpu", mesh=mesh)


def train_history(trainer, batches) -> list[float]:
    trainer.train(iter(batches))
    return [r["train/loss"] for r in trainer.history if "train/loss" in r]


# -- the scenarios -----------------------------------------------------------------
def scenario_dist(rank, world, tmp, inp):
    """Host helpers, ``shard_for_process``, the mesh and global eval metrics."""
    from edm_tts_tpu_torch.data.pipeline import shard_for_process
    from edm_tts_tpu_torch.parallel import dist, mesh

    out = {"info": dist.process_info()}
    dist.barrier()
    out["gathered"] = dist.all_gather_metrics(rank + 1.0).tolist()
    # rank r holds r + 1 batches with total 10 * (r + 1)
    out["global_mean"] = dist.global_mean_metrics({"a": 10.0 * (rank + 1), "b": 1.0 * rank},
                                                  rank + 1)
    out["shard"] = list(shard_for_process(range(10), *dist.process_info()))
    m = mesh.make_mesh(n_fsdp=2)
    out["mesh"] = (m.shape, m.coords, m.index("batch"),
                   torch.distributed.get_process_group_ranks(m.group("fsdp")), m.group("data"))
    errors = []
    for make in (lambda: mesh.make_mesh(1, 1), lambda: mesh.make_mesh(n_fsdp=3),
                 lambda: mesh.make_hybrid_mesh(3), lambda: mesh.make_hybrid_mesh(1, n_fsdp=4)):
        try:
            make()
        except ValueError:
            errors.append(True)
    out["mesh_errors"] = errors
    out["hybrid"] = mesh.make_hybrid_mesh(1, n_fsdp=2).shape
    # the trainers' eval: each rank a different number of different batches
    model = copy.deepcopy(inp["s2a"])
    trainer = s2a_trainer(model, os.path.join(tmp, "s2a"), steps=1, batch=4)
    with torch.no_grad():
        def eval_fn(batch):
            o = model.forward_train(batch["acoustic_tokens"], batch["semantic_tokens"],
                                    mask_override=batch["mask"])
            return {"loss": o["loss"]}
        trainer.eval_fn = eval_fn
        out["s2a_eval"] = trainer.evaluate(inp["eval_batches"][rank])
    gan = gan_trainer(copy.deepcopy(inp["codec"]), copy.deepcopy(inp["disc"]),
                      os.path.join(tmp, "gan"), steps=1)
    out["gan_eval"] = gan.evaluate(inp["eval_audio"][rank])
    return out


def scenario_data_parallel(rank, world, tmp, inp):
    """4 ranks, data 2 x fsdp 2: s2a (drawn masks and dropout; and the given
    masks of the JAX comparison), t2s and the codec GAN (data 4)."""
    out = {}
    trainer = s2a_trainer(copy.deepcopy(inp["s2a_drop"]), os.path.join(tmp, "s2a"), steps=3,
                          batch=8, n_fsdp=2, save_steps=2)
    out["s2a_losses"] = train_history(trainer, inp["s2a_batches"])
    out["s2a_params"] = trainable(trainer.model)
    out["moments"] = (trainer.optimizer.mu.numel(), trainer.optimizer.nu.numel(),
                      sum(p.numel() for p in trainer.optimizer.params))
    trainer = s2a_trainer(copy.deepcopy(inp["s2a"]), os.path.join(tmp, "s2a_mask"), steps=2,
                          batch=8, n_fsdp=2, learning_rate=inp["jax_lr"])
    out["mask_losses"] = train_history(trainer, inp["mask_batches"])
    out["mask_params"] = trainable(trainer.model)
    trainer = t2s_trainer(copy.deepcopy(inp["t2s"]), os.path.join(tmp, "t2s"), steps=2, batch=8,
                          n_fsdp=2)
    out["t2s_losses"] = train_history(trainer, inp["t2s_batches"])
    out["t2s_params"] = trainable(trainer.model)
    gan = gan_trainer(copy.deepcopy(inp["codec"]), copy.deepcopy(inp["disc"]),
                      os.path.join(tmp, "gan"), steps=1, disc_lr=0.0)
    gan.g_opt.write_grads = gan.d_opt.write_grads = True  # the reduced gradients, to compare
    gan.train(iter([inp["audio"]]))
    out["gan_history"] = [r for r in gan.history if "train/loss" in r]
    out["gan_params"] = (trainable(gan.codec), trainable(gan.disc))
    out["gan_grads"] = ({n: p.grad.clone() for n, p in gan.g_opt.named},
                        {n: p.grad.clone() for n, p in gan.d_opt.named})
    return out


def scenario_resume2(rank, world, tmp, inp):
    """2 ranks (fsdp 2) resume the 4-rank s2a run's step-2 checkpoint."""
    trainer = s2a_trainer(copy.deepcopy(inp["s2a_drop"]), os.path.join(tmp, "resume2"),
                          steps=3, batch=8, n_fsdp=2, micro_batches=2)
    losses = train_history(trainer, inp["s2a_batches"][2:])
    return {"losses": losses, "params": trainable(trainer.model)}


def _ring_grads(q, k, v, mask, group, rank, n):
    """This rank's blocks of q, k, v, the ring's output block and the
    gradients of sum over ranks of mean(out ** 2) with respect to them."""
    from edm_tts_tpu_torch.ops.ring_attention import ring_mha

    t = q.shape[1] // n
    local = [x[:, rank * t:(rank + 1) * t].clone().requires_grad_() for x in (q, k, v)]
    m = None if mask is None else mask[:, rank * t:(rank + 1) * t]
    out = ring_mha(*local, group=group, mask=m)
    (out.float().square().sum() / q.numel()).backward()
    return out.detach(), [x.grad for x in local]


def scenario_ring(rank, world, tmp, inp):
    """4 ranks: ring attention on the ring of 4 (f32, masks) and on rings
    of 2 (bf16); a Conformer with ``attn_implementation="ring"``; a
    ``Trainer`` step with n_seq 2 (x data 2)."""
    from edm_tts_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    q, k, v = (torch.as_tensor(x) for x in inp["qkv"])
    ring4 = mesh_lib.make_mesh(n_seq=4)
    group = ring4.group("sequence")
    out["plain"], _ = _ring_grads(q, k, v, None, group, rank, 4)
    out["masked"], _ = _ring_grads(q, k, v, torch.as_tensor(inp["mask_dead_row"]), group, rank, 4)
    out["grad_out"], out["grads"] = _ring_grads(q, k, v, torch.as_tensor(inp["mask"]), group,
                                                rank, 4)
    ring2 = mesh_lib.make_mesh(n_data=2, n_seq=2)
    r2 = ring2.index("sequence")
    out["bf16"], _ = _ring_grads(*(x.bfloat16() for x in (q, k, v)), None,
                                 ring2.group("sequence"), r2, 2)
    # the Conformer: whole activations on every rank, the attention on the ring
    model = inp["ring_conformer"]
    x, mask = torch.as_tensor(inp["x"]), torch.as_tensor(inp["conformer_mask"])
    with ring4:
        y = model(x, mask=mask, conv_pad_mask=mask)
        (y.square() * mask[..., None]).mean().backward()
    out["conformer"] = y.detach()
    out["conformer_grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    trainer = s2a_trainer(copy.deepcopy(inp["ring_s2a"]), os.path.join(tmp, "s2a_ring"), steps=1,
                          batch=4, n_seq=2)
    out["step"] = trainer.train_step(inp["s2a_batch"], 0)
    out["step_params"] = trainable(trainer.model)
    return out


def scenario_tp(rank, world, tmp, inp):
    """4 ranks: a Conformer split over 2 (x data 2) and over 4 model ranks,
    dropout on; an s2a ``Trainer`` step on fsdp 2 x model 2, then its
    checkpoint."""
    from edm_tts_tpu_torch.parallel import mesh as mesh_lib
    from edm_tts_tpu_torch.parallel.tensor import tensor_parallel

    out = {}
    x, mask = torch.as_tensor(inp["x"]), torch.as_tensor(inp["mask"])
    for n_model in (2, 4):
        mesh = mesh_lib.make_mesh(n_model=n_model)
        model = copy.deepcopy(inp["conformer"])
        plan = tensor_parallel(model, mesh)
        # with dropout (against one process), then without (against JAX)
        for tag, gen in (("", torch.Generator().manual_seed(5)), ("_nodrop", None)):
            model.zero_grad(set_to_none=True)
            y = model(x, mask=mask, conv_pad_mask=mask, dropout_generator=gen)
            (y.square() * mask[..., None]).mean().backward()
            out[f"y{n_model}{tag}"] = y.detach()
            out[f"grads{n_model}{tag}"] = plan.gather_state(
                {n: p.grad for n, p in model.named_parameters()})
        out[f"local{n_model}"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
        with torch.no_grad():
            out[f"attn{n_model}"] = model(x, mask=mask, conv_pad_mask=mask, return_attn=True)
    trainer = s2a_trainer(copy.deepcopy(inp["s2a"]), os.path.join(tmp, "s2a_tp"), steps=1,
                          batch=4, n_fsdp=2, n_model=2)
    out["step"] = trainer.train_step(inp["s2a_batch"], 0)
    out["step_params"] = trainer.model_state()
    trainer.save(1)
    return out


def _stack_run(inp, mesh, grad: bool):
    """The executor on the Conformer stack ``inp["stack"]`` over ``mesh``:
    this rank's rows of every microbatch of ``inp["x"]`` (M, MB, T, D), the
    outputs and, with ``grad``, the whole gradient of mean(out ** 2)."""
    from edm_tts_tpu_torch.ops import rope_frequencies
    from edm_tts_tpu_torch.parallel.pipeline import micro_rows, pipeline_apply, split_stages

    if mesh is None:
        return None
    model = copy.deepcopy(inp["stack"])
    plan = split_stages(model.layers, mesh, "layers")
    x = torch.as_tensor(inp["x"])
    m, mb = x.shape[:2]
    rows = micro_rows(m * mb, m, mesh)
    local = x.reshape(m * mb, *x.shape[2:])[rows].reshape(m, -1, *x.shape[2:])
    rope = rope_frequencies(x.shape[2], model.cfg.dim_head)

    def stage_fn(stage, act, side):
        h = act["x"]
        for g in plan.layers(stage):
            h = model.layers[g](h, rope=rope)
        return {"x": h}

    with torch.set_grad_enabled(grad):
        y = pipeline_apply(stage_fn, {"x": local}, mesh)["x"]
        if grad:
            y.square().mean().backward()
    out = {"y": y.detach(), "rows": rows,
           "names": [n for n, _ in model.named_parameters()]}
    if grad:
        out["grads"] = plan.gather_state({n: p.grad for n, p in model.named_parameters()})
    return out


def _passthrough(mesh):
    """Pipe 2, M 3: stage 0 doubles x and adds m, stage 1 triples and adds
    m; m, int ids beyond f32's integers and bool flags ride along. Returns
    the outputs and d sum(out x) / dx."""
    from edm_tts_tpu_torch.parallel.pipeline import pipeline_apply

    if mesh is None:
        return None

    def stage_fn(stage, act, side):
        return {"x": act["x"] * (2.0, 3.0)[stage] + act["m"], "m": act["m"], "ids": act["ids"],
                "flag": act["flag"]}

    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    feed = {"x": x, "m": torch.ones(3, 2),
            "ids": torch.tensor([[2 ** 24 + 1, 2 ** 30 - 3]] * 3, dtype=torch.int32),
            "flag": torch.tensor([[True, False]] * 3)}
    out = pipeline_apply(stage_fn, feed, mesh)
    out["x"].sum().backward()
    return {**{k: v.detach() for k, v in out.items()}, "dx": x.grad}


def _s2a_run(inp, mesh):
    """The pipelined s2a loss, gradients and logits over ``mesh`` on
    ``inp["s2a"]`` with ``inp["batch"]`` (2 microbatches): the global loss,
    this rank's rows and their logits, the whole gradients (gathered over
    model, then pipe) and this rank's parameter names."""
    from edm_tts_tpu_torch.models.s2a.pipeline import (
        pipelined_forward_logits,
        pipelined_train_loss,
        prepare_train_inputs,
    )
    from edm_tts_tpu_torch.parallel.pipeline import micro_rows, reduce_gradients, split_stages
    from edm_tts_tpu_torch.parallel.tensor import tensor_parallel

    if mesh is None:
        return None
    model = copy.deepcopy(inp["s2a"])
    plan = split_stages(model.encoder.layers, mesh, "encoder.layers")
    tp = tensor_parallel(model, mesh) if mesh.size("model") > 1 else None
    names = [n for n, _ in model.named_parameters()]
    ac, sem, mask = (torch.as_tensor(inp["batch"][k]) for k in ("ac", "sem", "mask"))
    loss = pipelined_train_loss(model, ac, sem, mask, mesh, n_micro=2)
    loss.backward()
    reduce_gradients(model, mesh)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    if tp is not None:
        grads = tp.gather_state(grads)
    grads = plan.gather_state(grads)
    rows = micro_rows(len(sem), 2, mesh)
    with torch.no_grad():
        enc_in, teacher = prepare_train_inputs(model, ac[rows], sem[rows], mask[rows])
        logits = pipelined_forward_logits(model, enc_in, teacher, mesh, n_micro=2)
    return {"loss": loss.item(), "rows": rows, "logits": logits, "grads": grads,
            "names": names}


# the pipe layouts of the GPipe scenarios: (n_pipe, n_data, n_model)
GPIPE4 = {"pipe4": (4, 1, 1), "pipe2": (2, 1, 1), "pipe2_data2": (2, 2, 1),
          "pipe2_model2": (2, 1, 2)}
GPIPE8 = {"pipe4_data2": (4, 2, 1), "pipe4_model2": (4, 1, 2),
          "pipe2_data2_model2": (2, 2, 2)}


def scenario_gpipe4(rank, world, tmp, inp):
    """4 ranks: the executor on a Conformer stack (pipe 4 with gradients,
    pipe 2, pipe 2 x data 2, pass-through fields), the s2a walk on GPIPE4's
    layouts and on a local pipe 4 in each process."""
    from edm_tts_tpu_torch.parallel.mesh import make_pipe_mesh

    out = {"stack4": _stack_run(inp, make_pipe_mesh(4), grad=True),
           "stack2": _stack_run(inp, make_pipe_mesh(2), grad=False),
           "stack2_data2": _stack_run(inp, make_pipe_mesh(2, n_data=2), grad=False),
           "passthrough": _passthrough(make_pipe_mesh(2))}
    for key, shape in GPIPE4.items():
        out[key] = _s2a_run(inp, make_pipe_mesh(*shape))
    out["pipe4_local"] = _s2a_run(inp, make_pipe_mesh(4, local=True))
    return out


def scenario_gpipe8(rank, world, tmp, inp):
    """8 ranks: the s2a walk on GPIPE8's layouts, then every leg of
    ``dryrun_multichip`` (gloo)."""
    from edm_tts_tpu_torch import dryrun_multichip
    from edm_tts_tpu_torch.parallel.mesh import make_pipe_mesh

    out = {key: _s2a_run(inp, make_pipe_mesh(*shape)) for key, shape in GPIPE8.items()}
    lines = []
    out["dryrun"] = dryrun_multichip.run(torch.device("cpu"), log=lines.append)
    out["dryrun_lines"] = lines
    return out


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


def main() -> None:
    scenario, tmp = sys.argv[1], sys.argv[2]
    from edm_tts_tpu_torch.parallel import dist

    device = dist.initialize("cpu")
    assert device.type == "cpu"
    torch.set_num_threads(1)
    rank, world = dist.process_info()
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    out = SCENARIOS[scenario](rank, world, tmp, inp)
    torch.save(out, os.path.join(tmp, f"{scenario}_rank{rank}.pt"))
    dist.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
