"""Training steps: back-to-back ``Trainer.train_step`` calls of the s2a
recipe on batches made on the device from the seed.

Parameters (the cell's ``traffic``): none beyond the configuration's
``recipe`` (batch, frames, micro-batches, optimizer). Each step's batch
(acoustic codes, semantic tokens, and the masked positions, one cosine-
schedule rate per row) is drawn from its own device generator keyed by
the seed and the step, so every row differs; the input pipeline is
bypassed, and the benchmark hands the trainer the mask (the recipe's
``mask`` batch key) so that the reference can use the same one.

Set-up builds one ``Trainer`` (the f32 model from the seeded weights, the
frozen codec, AdamW) and runs the recipe's first three steps through the
window's own call and feed; they warm the step up, and the reference
follows them after the window (``check_train``). The window then runs
steps until ``--seconds`` have passed and closes when the last step's
update is done.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from portbench import arith, weights
from portbench.check_train import Readings, compare, reference_readings, worst_leaves
from portbench.harness import Check, Context, Run
from portbench.reference import model as ref
from portbench.reference import shapes
from portbench.trace import Tracer

COMPARED_STEPS = 3


def make_batch(cfg: dict, seed: int, step: int, device) -> dict[str, torch.Tensor]:
    rc, codec = cfg["recipe"], cfg["codec"]
    b, t = rc["per_device_train_batch_size"], rc["frames"]
    gen = torch.Generator(device=device).manual_seed(weights.mix(seed, 10_000 + step))
    acoustic = torch.randint(0, codec["codebook_size"], (b, codec["n_codebooks"], t),
                             generator=gen, device=device)
    semantic = torch.randint(0, cfg["s2a"]["num_semantic_tokens"], (b, t), generator=gen,
                             device=device)
    rate = torch.cos(torch.rand((b, 1), generator=gen, device=device) * (torch.pi / 2))
    mask = torch.rand((b, t), generator=gen, device=device) < rate
    return {"acoustic_tokens": acoustic, "semantic_tokens": semantic, "mask": mask}


def build_trainer(cfg: dict, state: dict, device, output_dir: str):
    from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
    from edm_tts_tpu_torch.train.optim import freeze_submodule
    from edm_tts_tpu_torch.train.run_s2a import s2a_loss
    from edm_tts_tpu_torch.train.trainer import Trainer, TrainingArguments

    rc = cfg["recipe"]
    model = InjectionConformer(S2AConfig.from_dict({**cfg["s2a"], "codec": cfg["codec"]}),
                               device=device, dtype=torch.float32)
    weights.load_into(model, state)
    freeze_submodule(model, "acoustic_model")
    args = TrainingArguments(
        output_dir=output_dir, seed=0,
        per_device_train_batch_size=rc["per_device_train_batch_size"],
        max_steps=rc["max_steps"], learning_rate=rc["learning_rate"],
        warmup_steps=rc["warmup_steps"], weight_decay=rc["weight_decay"],
        adam_beta1=rc["adam_beta1"], adam_beta2=rc["adam_beta2"],
        adam_epsilon=rc["adam_epsilon"], max_grad_norm=rc["max_grad_norm"],
        micro_batches=rc["micro_batches"])
    _, loss_fn = s2a_loss(model, bf16=rc["bf16"])
    return Trainer(args, model, loss_fn, device=device)


def program_readings(trainer, batches: list, b1: float) -> Readings:
    """The first steps through ``train_step``, with what they gave."""
    named = trainer.optimizer.named
    start = {n: p.detach().clone() for n, p in named}
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches):
        metrics = trainer.train_step(batch, step)
        losses.append(float(metrics["loss"]))
        if step == 0:
            mu = trainer.optimizer.state_dict()["mu"]
            grad_norms = {n: float(mu[n].norm()) / (1.0 - b1) for n, _ in named}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    return Readings(losses, grad_norms, change)


def run(ctx: Context) -> Run:
    cfg, dev = ctx.config, ctx.device
    rc = cfg["recipe"]
    state = weights.make_state(shapes.s2a_shapes(cfg["s2a"], cfg["codec"]),
                               weights.mix(ctx.seed, 2), dtype=torch.float32, device=dev)
    batches = [make_batch(cfg, ctx.seed, s, dev) for s in range(COMPARED_STEPS)]
    if ctx.control:
        return control(ctx, state, batches)
    run = ctx.new_run()
    cuda = dev.type == "cuda"
    tokens = rc["per_device_train_batch_size"] * rc["frames"]
    flops = arith.s2a_train_flops(cfg["s2a"], cfg["codec"], rc["per_device_train_batch_size"],
                                  rc["frames"])
    arch = arith.s2a_arch(cfg["s2a"])
    micro = rc["per_device_train_batch_size"] // rc["micro_batches"]
    attn_least = arch["depth"] * rc["micro_batches"] * arith.attention_fwd_bwd_least_s(
        micro, rc["frames"], arch["heads"], arch["dim_head"])
    tr = ctx.spec["trace"]
    first, last = tr["first"], tr["first"] + tr["count"]
    tracer = Tracer() if ctx.traced else None
    with tempfile.TemporaryDirectory(prefix="portbench_", dir=os.environ.get("TMPDIR")) as out:
        trainer = build_trainer(cfg, state, dev, out)
        if cuda:
            from edm_tts_tpu_torch import kernels
            kernels.reset_launches()
        prog = program_readings(trainer, batches, rc["adam_beta1"])
        if cuda:
            ctx.say(f"crosscheck K3/K4 launches over {COMPARED_STEPS} steps: "
                    f"{kernels.launches['attention']} / {kernels.launches['attention_bwd']} "
                    f"(benchmark: {COMPARED_STEPS * arch['depth'] * rc['micro_batches']} each)")
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        run.t_open = time.perf_counter()
        run.setup_s = run.t_open - ctx.t_start
        step = COMPARED_STEPS
        t0 = run.t_open
        while True:
            i = step - COMPARED_STEPS
            if tracer is not None and i == first:
                tracer.start()
                t0 = time.perf_counter()
            trainer.train_step(make_batch(cfg, ctx.seed, step, dev), step)
            traced = tracer is not None and first <= i < last
            if tracer is not None and i == last - 1:
                tracer.stop(tr["count"])
            t1 = time.perf_counter()
            run.attempted += 1
            run.calls.append({"start": t0, "end": t1, "tokens": tokens, "flops": flops,
                              "traced": traced, "attn_least_s": attn_least})
            t0 = t1
            step += 1
            if t1 - run.t_open >= ctx.seconds and (tracer is None or i >= last - 1):
                break
        if cuda:
            torch.cuda.synchronize()
        run.t_close = time.perf_counter()
        run.calls[-1]["end"] = run.t_close
        if cuda:
            run.extra["window_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            run.extra["memory_peak_bytes"] = max(setup_peak, run.extra["window_peak_bytes"])
        run.trace = tracer.result() if tracer is not None else None
        trainer.metrics.close()
        del trainer
    if cuda:
        torch.cuda.empty_cache()
    judge(ctx, run, prog, state, batches)
    return run


def judge(ctx: Context, run: Run, prog: Readings, state: dict, batches: list) -> None:
    t0 = time.perf_counter()
    with ref.exact_f32():
        refr = reference_readings(ctx.config, state, batches)
    numbers = compare(prog, refr)
    ctx.say(f"reference: {len(batches)} steps in {time.perf_counter() - t0:.1f} s; losses "
            f"program {prog.losses} reference {refr.losses}; worst gradient leaves "
            f"{worst_leaves(prog, refr)}")
    limits = ctx.spec["limits"]
    run.checks = [Check(k, v, limits[k]) for k, v in numbers.items()]


def control(ctx: Context, state: dict, batches: list) -> Run:
    """The reference in the program's place, judged as the program is: at
    fp8 (the control), or with each batch's second half left out of the
    step's mean (the planted fault "half_batch")."""
    run = ctx.new_run()
    with ref.exact_f32():
        if ctx.control == "half_batch":
            half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
            low = reference_readings(ctx.config, state, half)
        else:
            low = reference_readings(ctx.config, state, batches, precision="fp8")
    judge(ctx, run, low, state, batches)
    return run
