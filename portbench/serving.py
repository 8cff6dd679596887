"""The served stack of a serving cell: the port's ``TTSEngine`` over
seeded weights, the speaker prompt, and the recorder the benchmark puts at
the boundaries of the engine's stages.

``Recorder`` wraps, on the model objects the benchmark built, the calls
into each stage: the t2s length predictor and each t2s pass (its canvas),
the s2a semantic embedding, each first-level pass (its input), each level-0
commit (its ids), the full pass (its input) and the codec decode (its
codes). While ``capture`` holds a dict, the wrappers keep references to
those inputs there (nothing is copied or synchronized); while ``spans`` is
set, each stage runs inside a ``record_function`` span named after it, so
a trace labels the host's time by stage. The correctness check
(``check_serve``) reads what was kept.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from portbench import weights
from portbench.harness import Check
from portbench.reference import shapes


@dataclasses.dataclass
class Served:
    engine: object
    t2s_state: dict
    s2a_state: dict
    prompt_acoustic: torch.Tensor  # (1, Q, Tp)
    prompt_semantic: torch.Tensor  # (1, Tp)
    recorder: "Recorder"


def make_states(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """The t2s and s2a state dicts (bf16) from ``seed``; the length head is
    scaled as the configuration's ``assumed`` says, so that random weights
    predict lengths of a long sentence rather than a frame or two."""
    t2s = weights.make_state(shapes.t2s_shapes(cfg["t2s"]), weights.mix(seed, 1),
                             dtype=torch.bfloat16, device=device)
    s2a = weights.make_state(shapes.s2a_shapes(cfg["s2a"], cfg["codec"]), weights.mix(seed, 2),
                             dtype=torch.bfloat16, device=device)
    a = cfg["assumed"]
    t2s["length_pred_head.weight"] = t2s["length_pred_head.weight"] * a["length_head_scale"]
    t2s["length_pred_head.bias"] = torch.full_like(t2s["length_pred_head.bias"],
                                                   math.log(a["length_head_frames"]))
    return t2s, s2a


_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def random_text(rng, n: int) -> str:
    """``n`` bytes of words of 2-9 lowercase letters between single spaces,
    ending in a full stop."""
    words, size = [], 0
    while size < n:
        w = "".join(rng.choice(_LETTERS) for _ in range(rng.randint(2, 9)))
        words.append(w)
        size += len(w) + 1
    return (" ".join(words))[: n - 1] + "."


def make_prompt(cfg: dict, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A speaker prompt of ``prompt_frames`` random codes from ``seed``."""
    gen = torch.Generator().manual_seed(weights.mix(seed, 3))
    codec, tp = cfg["codec"], cfg["assumed"]["prompt_frames"]
    acoustic = torch.randint(0, codec["codebook_size"], (1, codec["n_codebooks"], tp), generator=gen)
    semantic = torch.randint(0, cfg["s2a"]["num_semantic_tokens"], (1, tp), generator=gen)
    return acoustic, semantic


def fp8_decode(cfg: dict, s2a_state: dict):
    """The codec decode as the control runs it: the reference's decoder
    with every convolution's operands in float8 e4m3, each row at its own
    length, zero-padded to the canvas the engine decodes."""
    from portbench.reference import model as ref

    params = ref.Params(s2a_state, precision="fp8")
    codec = cfg["codec"]

    @torch.no_grad()
    def decode(codes: torch.Tensor, valid_frames: torch.Tensor | None = None) -> torch.Tensor:
        b, _, t = codes.shape
        frames = valid_frames.tolist() if valid_frames is not None else [t] * b
        out = torch.zeros((b, t * ref.hop(codec) + 16, 1), device=codes.device)
        for r, n in enumerate(frames):
            wave = ref.decode(params, codec, codes[r:r + 1, :, :n])[0]
            out[r, :wave.shape[0], 0] = wave
        return out.to(torch.bfloat16)

    return decode


@torch.no_grad()
def _fp8_weights(*models) -> None:
    """Round every weight matrix the int8 sites left in float (embeddings,
    learned tokens, feature projections, the heads outside the sites, the
    RVQ's codebooks and projections) to float8 e4m3, per tensor."""
    from portbench.reference.model import fake_e4m3

    for model in models:
        for name, p in model.named_parameters():
            if p.dim() >= 2 and not name.startswith(("acoustic_model.encoder.",
                                                     "acoustic_model.decoder.")):
                p.copy_(fake_e4m3(p.float()).to(p.dtype))


def build(cfg: dict, seed: int, device, *, control: bool = False) -> Served:
    """The engine over seeded weights with the prompt registered as "spk".
    ``control``: the control in the program's place, every part one
    precision step below the configuration: the program's own int8
    activations (``quantize="w8a8"``) at the int8 sites, every other weight
    matrix of the t2s and s2a models in float8 (``_fp8_weights``), and the
    codec decode as ``fp8_decode``."""
    from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
    from edm_tts_tpu_torch.models.t2s import T2SConfig, TextToSemantic
    from edm_tts_tpu_torch.serving import TTSEngine

    sv = cfg["serving"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[sv["dtype"]]
    t2s_state, s2a_state = make_states(cfg, seed, device)
    t2s = TextToSemantic(T2SConfig.from_dict(cfg["t2s"]), device=device, dtype=dtype).eval()
    s2a = InjectionConformer(S2AConfig.from_dict({**cfg["s2a"], "codec": cfg["codec"]}),
                             device=device, dtype=dtype).eval()
    weights.load_into(t2s, t2s_state)
    weights.load_into(s2a, s2a_state)
    engine = TTSEngine.from_models(
        t2s, s2a, device=device, quantize="w8a8" if control else sv["quantize"],
        pred_iters=sv["pred_iters"],
        s2a_steps=sv["s2a_steps"], temperature=sv["temperature"],
        max_speech_len=sv["max_speech_len"], text_bucket=sv["text_bucket"],
        length_bucket=sv["length_bucket"], batch_buckets=tuple(sv["batch_buckets"]))
    acoustic, semantic = make_prompt(cfg, seed)
    engine.register_speaker_codes("spk", acoustic, semantic)
    if control:
        _fp8_weights(engine.t2s, engine.s2a)
        engine.s2a.acoustic_model.decode_from_codes = fp8_decode(cfg, s2a_state)
    return Served(engine, t2s_state, s2a_state, acoustic, semantic, Recorder(engine.t2s, engine.s2a))


class Recorder:
    def __init__(self, t2s, s2a):
        self.capture: dict | None = None
        self.spans = False
        self._in = set()
        self._wrap(t2s, "predict_log_length", "t2s.length", None)
        self._wrap(t2s, "embed", "t2s.embed", self._t2s_embed)
        self._wrap(t2s, "embeddings_to_logits", "t2s.pass", None)
        self._wrap(s2a, "embed_semantic", "s2a.embed", self._semantic)
        self._wrap(s2a, "forward_first_level", "s2a.first_level", self._first)
        self._wrap(s2a, "acoustic_features", "s2a.commit", self._commit)
        self._wrap(s2a, "forward_logits", "s2a.full", self._full)
        self._wrap(s2a.acoustic_model, "decode_from_codes", "codec.decode", self._decode)

    def _wrap(self, obj, name: str, span: str, keep) -> None:
        fn = getattr(obj, name)

        def wrapped(*args, **kwargs):
            inner = name in ("predict_log_length", "forward_logits")
            if inner:
                self._in.add(name)
            try:
                if self.spans:
                    with torch.profiler.record_function(span):
                        out = fn(*args, **kwargs)
                else:
                    out = fn(*args, **kwargs)
            finally:
                if inner:
                    self._in.discard(name)
            if self.capture is not None and keep is not None:
                keep(self.capture, out, *args, **kwargs)
            return out

        setattr(obj, name, wrapped)

    def _t2s_embed(self, cap, out, tokens):
        if "predict_log_length" not in self._in:
            cap.setdefault("canvases", []).append(tokens)

    def _semantic(self, cap, out, tokens):
        cap.setdefault("semantic", tokens)

    def _first(self, cap, out, x, pad_mask=None):
        cap.setdefault("first_x", []).append(x)

    def _commit(self, cap, out, ids):
        if "forward_logits" not in self._in:
            cap.setdefault("commit_ids", []).append(ids[:, 0])

    def _full(self, cap, out, x, **kwargs):
        cap["full_x"] = x

    def _decode(self, cap, out, codes, valid_frames=None):
        cap["codes"] = codes
        cap["lengths"] = valid_frames


def judge(ctx, run, served: Served, kept: list, missing: int = 0) -> None:
    """Read the peak memory, free the program's state, then have the
    reference judge every row of the kept calls (``(capture, texts,
    gt_lengths or None, waveforms or None, seed)`` each), ``rows_per_block``
    rows at a time; ``missing`` sampled requests never came back."""
    from portbench.check_serve import ServeCheck
    from portbench.reference import model as ref

    cuda = ctx.device.type == "cuda"
    run.extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    check = ServeCheck(ctx.config, served.t2s_state, served.s2a_state, served.prompt_acoustic,
                       served.prompt_semantic, ctx.device)
    served.engine = served.recorder = None
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    block = ctx.spec["check"]["rows_per_block"]
    with ref.exact_f32():
        for cap, texts, gt, waves, seed in kept:
            if waves is None:
                missing += len(texts)
                continue
            for lo in range(0, len(texts), block):
                check.call(cap, texts, gt, waves, list(range(lo, min(lo + block, len(texts)))),
                           seed)
    check.readings["answer"] = max(check.readings["answer"], float(missing))
    ctx.say(f"reference: {check.rows} rows of {len(kept)} calls, {check.tokens} served tokens "
            f"judged in {time.perf_counter() - t0:.1f} s")
    limits = ctx.spec["limits"]
    run.checks = [Check(k, v, limits[k]) for k, v in check.readings.items() if k in limits]
    run.notes["readings not compared"] = {k: v for k, v in check.readings.items()
                                          if k not in limits}
