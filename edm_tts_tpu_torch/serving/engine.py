"""TTS engine: the staged zero-shot pipeline behind a bucketed serving
surface (port of edm_tts_tpu/serving/engine.py).

Text length, speech-canvas length and batch size are rounded up to a few
buckets and the padding is masked (``semantic_valid`` in the s2a sampler,
``valid_frames`` in the codec decode, batch rows repeated from row 0), so
requests of nearby sizes run the same shapes and a padded request gives the
waveform of its exact-size run. On the card the Conformer attention runs as
kernel K3, the decoder's residual units as K1, and with ``quantize="int8"``
every quantized linear as K5.

Speaker prompts are tokenized once and reused by every request:
``register_speaker`` takes a wav (resampled to 16 kHz on the engine's
device, then the codec encoder with its RVQ and HuBERT with k-means through
``AudioTokenizer``: K1 on the encoder's residual units and K3 in HuBERT's
attention on the card), ``register_speaker_codes`` takes precomputed codes.
The engine is built from model directories with ``from_dirs`` (the JAX
engine's constructor: ``utils.hub``'s loaders, in the engine's ``dtype``),
or from in-memory models with ``from_models``.

Data-parallel serving (``mesh``, the JAX engine's option): a list of
devices, each holding a replica of the models; every batch bucket must be
divisible by their number. A batch's rows are split contiguously over the
replicas, which run concurrently (one host thread each) with the same seed
and their first row's index as the samplers' ``row_offset``; the t2s stage
ends on every replica before the s2a canvas length is taken from all rows,
so the audio is the single-device engine's.

Spans (``utils.profiling``, while it records): ``engine.synthesize``
around a call, with its ``t2s_positions`` (the bucket's rows times the t2s
canvas, ``Lt + 4 + max_speech_len``) and ``t2s_used`` (over the real rows,
4 + text bytes + speech frames: the positions a row's own canvas would
hold); inside it ``engine.t2s``, which ends at the copy of the lengths to
the host and so holds the t2s stage's device time. A single-device engine
then records ``engine.s2a`` (the host's enqueue of the s2a sampler alone)
and ``engine.decode``, which ends at the copy of the waveforms to the host
and so holds the device time of the s2a sampler and the decode; a mesh
engine runs each replica's s2a and decode as one task, which no span
splits.

Randomness: one CPU ``torch.Generator`` seeded with the request's seed
drives both samplers. It cannot reproduce the JAX package's
``jax.random`` streams, so the two engines agree only at temperature 0 with
greedy sampling (tests/test_torch_serving.py).
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses

import numpy as np
import torch

from edm_tts_tpu_torch.models import quantize as quantization
from edm_tts_tpu_torch.models.s2a import InjectionConformer, s2a_sample
from edm_tts_tpu_torch.models.t2s import TextToSemantic, t2s_sample
from edm_tts_tpu_torch.models.tokenizer import AudioTokenizer, SemanticTokenizerHubert
from edm_tts_tpu_torch.ops.resample import resample
from edm_tts_tpu_torch.serving.chunking import default_chunk_chars, join_waveforms, split_text
from edm_tts_tpu_torch.utils.bucketing import bucket_batch, bucket_length
from edm_tts_tpu_torch.utils.profiling import span


def no_grad(fn):
    """``fn`` under ``torch.no_grad()`` in whichever thread runs it (grad
    mode is per thread)."""
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


@dataclasses.dataclass(frozen=True)
class SpeakerPrompt:
    acoustic_codes: torch.Tensor  # (1, Q, Tp)
    semantic_codes: torch.Tensor  # (1, Tp)


class TTSEngine:
    def __init__(
        self,
        t2s: TextToSemantic,
        s2a: InjectionConformer,
        semantic: SemanticTokenizerHubert | None = None,
        *,
        device: str | torch.device = "cuda",
        quantize: str = "none",
        quantize_t2s: str | None = None,
        quantize_s2a: str | None = None,
        pred_iters: int = 16,
        s2a_steps: int = 8,
        temperature: float = 1.0,
        max_speech_len: int = 1250,
        text_bucket: int = 32,
        length_bucket: int = 64,
        batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16),
        mesh=None,
    ):
        """See ``from_models``."""
        self.device = torch.device(device)
        self.t2s = quantization.quantize_t2s(t2s.to(self.device).eval(),
                                             quantize_t2s or quantize)
        self.s2a = quantization.quantize_s2a(s2a.to(self.device).eval(),
                                             quantize_s2a or quantize)
        # the codec's kernel layouts are plain tensors that .to() leaves behind
        self.s2a.acoustic_model.pack()
        if semantic is not None:
            semantic = semantic.to(self.device).eval()
        self.tokenizer = AudioTokenizer(self.s2a.acoustic_model, semantic)
        self.pred_iters = pred_iters
        self.s2a_steps = s2a_steps
        self.temperature = temperature
        self.max_speech_len = max_speech_len
        self.text_bucket = text_bucket
        self.length_bucket = length_bucket
        self.batch_buckets = tuple(sorted(batch_buckets))
        self._speakers: dict[str, SpeakerPrompt] = {}
        self.replicas = [(self.t2s, self.s2a, self.device)]
        if mesh is not None:
            devices = [torch.device(d) for d in mesh]
            if any(b % len(devices) for b in self.batch_buckets):
                raise ValueError(f"batch buckets {self.batch_buckets} must be divisible by the "
                                 f"data axis ({len(devices)} devices)")
            # the first replica is the engine's own models when it is on their device
            self.replicas = [(self.t2s, self.s2a, d) if i == 0 and d == self.device
                             else (copy.deepcopy(self.t2s).to(d), self._s2a_replica(d), d)
                             for i, d in enumerate(devices)]

    def _s2a_replica(self, device: torch.device) -> InjectionConformer:
        s2a = copy.deepcopy(self.s2a).to(device)
        s2a.acoustic_model.pack()
        return s2a

    @classmethod
    def from_models(cls, t2s: TextToSemantic, s2a: InjectionConformer,
                    semantic: SemanticTokenizerHubert | None = None, **opts) -> "TTSEngine":
        """An engine over in-memory models, moved to ``device`` (default the
        card; the CPU only when asked) and quantized in place.

        ``semantic`` (HuBERT with its k-means centroids) and the s2a's codec
        (``s2a.acoustic_model``) tokenize prompts for ``register_speaker``;
        without it speakers come as codes (``register_speaker_codes``). The
        tokenizer runs in the dtype its models were built in (bf16 on the
        card, as the JAX engine serves it) and is never quantized.

        ``quantize`` ("none", "int8" or "w8a8") applies to both models;
        ``quantize_t2s``/``quantize_s2a`` override it per model, as the JAX
        package's loaders take it. The other options are the JAX engine's:
        ``pred_iters``, ``s2a_steps``, ``temperature``, ``max_speech_len``,
        ``text_bucket``, ``length_bucket``, ``batch_buckets`` and ``mesh``
        (a list of devices, each given a replica of the models: batches are
        split over them; ValueError unless it divides every bucket).
        """
        return cls(t2s, s2a, semantic, **opts)

    @classmethod
    def from_dirs(cls, codec_model: str, t2s_model: str, s2a_model: str,
                  hubert_model: str | None, *, device: str | torch.device = "cuda",
                  dtype: torch.dtype = torch.bfloat16, **opts) -> "TTSEngine":
        """An engine over model directories (``utils.hub``'s formats), as
        the JAX engine is built: every model in ``dtype`` on ``device`` (the
        card unless the caller asks for the CPU). The prompt tokenizer's
        codec comes from ``codec_model`` and HuBERT with its centroids from
        ``hubert_model`` (None: speakers come as codes); the s2a decodes
        through its own codec. ``opts`` are ``from_models``' (``quantize``,
        ``quantize_t2s``, ``quantize_s2a``, ...)."""
        from edm_tts_tpu_torch.utils import hub

        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"from_dirs: dtype must be torch.bfloat16 or torch.float32, "
                             f"got {dtype!r}")
        kw = dict(device=device, dtype=dtype)
        semantic = None if hubert_model is None else hub.load_semantic_tokenizer(hubert_model, **kw)
        engine = cls(hub.load_t2s(t2s_model, **kw), hub.load_s2a(s2a_model, **kw), semantic,
                     device=device, **opts)
        engine.tokenizer = AudioTokenizer(hub.load_codec(codec_model, **kw), semantic)
        return engine

    # -- speakers -------------------------------------------------------
    @property
    def sample_rate(self) -> int:
        return self.s2a.cfg.codec.sample_rate

    @property
    def hop_length(self) -> int:
        """Waveform samples per frame."""
        return self.s2a.cfg.codec.hop_length

    def register_speaker(self, name: str, wav: np.ndarray, sr: int) -> None:
        """Tokenize a speaker prompt (mono ``(T,)`` at ``sr`` Hz) once and
        keep its codes for every request. ValueError for an empty wav, a rate
        that is not positive or an engine without a semantic tokenizer."""
        if self.tokenizer.semantic is None:
            raise ValueError("this engine has no semantic tokenizer (HuBERT + k-means); "
                             "build it with one, or register the prompt's codes with "
                             "register_speaker_codes")
        wav = np.array(wav, np.float32).reshape(-1)
        if wav.size == 0 or sr <= 0:
            raise ValueError(f"register_speaker: empty wav or sample rate {sr}")
        if sr != self.sample_rate:
            wav = resample(torch.from_numpy(wav).to(self.device), sr,
                           self.sample_rate).cpu().numpy()
        codes = self.tokenizer.compute_codes(wav[None])
        self._speakers[name] = SpeakerPrompt(codes["acoustic_codes"], codes["semantic_codes"])

    def register_speaker_codes(self, name: str, acoustic_codes, semantic_codes) -> None:
        """Register precomputed prompt codes (``(1, Q, Tp)`` acoustic,
        ``(1, Tp)`` semantic)."""
        def codes(x):
            x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
            return x.to(self.device, torch.long)

        self._speakers[name] = SpeakerPrompt(codes(acoustic_codes), codes(semantic_codes))

    def speakers(self) -> tuple[str, ...]:
        return tuple(self._speakers)

    def prompt(self, name: str) -> SpeakerPrompt:
        """The codes registered for speaker ``name``."""
        return self._speakers[name]

    # -- synthesis ------------------------------------------------------
    @torch.no_grad()
    def synthesize(
        self,
        texts: list[str],
        speaker: str,
        *,
        seed: int = 0,
        gt_lengths: list[int] | None = None,
    ) -> list[np.ndarray]:
        """Synthesize a batch of texts with one registered speaker.

        Returns one float32 waveform ``(n_samples,)`` per text, trimmed to
        its own length. The batch is padded up to the next batch bucket by
        repeating row 0; padded rows are computed and discarded (rows are
        independent through every stage)."""
        prompt = self._speakers[speaker]
        b_real = len(texts)
        if b_real < 1:
            raise ValueError("synthesize: no texts")
        b = bucket_batch(b_real, self.batch_buckets)
        byte_seqs = [[c + 5 for c in t.encode("utf-8")] for t in texts]
        byte_seqs += [byte_seqs[0]] * (b - b_real)
        lt = bucket_length(max(len(s) for s in byte_seqs), self.text_bucket)
        with span("engine.synthesize", t2s_positions=b * (lt + 4 + self.max_speech_len)) as s:
            audio, lengths = self._synthesize(byte_seqs, lt, prompt, seed, gt_lengths, b_real)
            if s is not None:
                s.counts["t2s_used"] = int(lengths[:b_real].sum()) + sum(
                    4 + len(q) for q in byte_seqs[:b_real])
        return [audio[i, : int(lengths[i]) * self.hop_length] for i in range(b_real)]

    def _synthesize(self, byte_seqs, lt, prompt, seed, gt_lengths, b_real):
        """(waveforms ``(b, samples)``, frames ``(b,)``), both numpy, of the
        bucket's ``b`` rows."""
        b = len(byte_seqs)
        dev = self.device
        text_tokens = torch.tensor([s + [0] * (lt - len(s)) for s in byte_seqs], device=dev)
        text_lengths = torch.tensor([len(s) for s in byte_seqs], device=dev)
        gt = None
        if gt_lengths is not None:
            gt = torch.tensor(list(gt_lengths) + [gt_lengths[0]] * (b - b_real), device=dev)

        n = len(self.replicas)
        rows = b // n

        def part(x, i):
            return None if x is None else x[i * rows:(i + 1) * rows].to(self.replicas[i][2])

        def run_t2s(i):
            t2s, _, device = self.replicas[i]
            generator = torch.Generator().manual_seed(seed)
            out = t2s_sample(
                t2s, part(text_tokens, i), part(text_lengths, i), generator,
                pred_iters=self.pred_iters, temperature=self.temperature,
                max_speech_len=self.max_speech_len, gt_length=part(gt, i), row_offset=i * rows)
            return out, generator

        def run_s2a(i, t2s_out, generator, n_max):
            _, s2a, device = self.replicas[i]
            lengths = t2s_out["lengths"]
            semantic_valid = torch.arange(n_max, device=device)[None, :] < lengths[:, None]
            pa, ps = (x.to(device) for x in (prompt.acoustic_codes, prompt.semantic_codes))
            return s2a_sample(
                s2a, t2s_out["semantic_tokens"][:, :n_max], pa.expand(rows, *pa.shape[1:]),
                ps.expand(rows, *ps.shape[1:]), generator, steps=self.s2a_steps,
                temperature=self.temperature, semantic_valid=semantic_valid, row_offset=i * rows)

        def run_decode(i, codes):
            s2a, lengths = self.replicas[i][1], stage1[i][0]["lengths"]
            return s2a.acoustic_model.decode_from_codes(codes, lengths)[..., 0].float().cpu()

        if n == 1:
            with span("engine.t2s"):
                stage1 = [run_t2s(0)]
                lengths = stage1[0][0]["lengths"].cpu()
            n_max = bucket_length(int(lengths.max()), self.length_bucket, self.max_speech_len)
            with span("engine.s2a"):
                codes = run_s2a(0, *stage1[0], n_max)
            with span("engine.decode"):
                audio = run_decode(0, codes)
        else:
            with concurrent.futures.ThreadPoolExecutor(n) as pool:
                with span("engine.t2s"):
                    stage1 = list(pool.map(no_grad(run_t2s), range(n)))
                    # the canvas of every row of the batch, whichever replica holds it
                    lengths = torch.cat([out["lengths"].cpu() for out, _ in stage1])
                n_max = bucket_length(int(lengths.max()), self.length_bucket,
                                      self.max_speech_len)
                audio = torch.cat(list(pool.map(
                    no_grad(lambda i: run_decode(i, run_s2a(i, *stage1[i], n_max))), range(n))))
        return audio.numpy(), lengths.numpy()

    def synthesize_long(
        self,
        text: str,
        speaker: str,
        *,
        seed: int = 0,
        max_chunk_chars: int | None = None,
        crossfade_ms: float = 30.0,
        gap_ms: float = 0.0,
    ) -> np.ndarray:
        """Synthesize arbitrarily long text as one waveform.

        Splits the text at sentence boundaries into chunks the canvas can
        hold (serving/chunking.py), synthesizes them as batched calls and
        joins the chunk waveforms with a short crossfade (or a silence gap).
        Runs on the calling thread; a server routes the chunks of a
        ``"long": true`` request through its batcher instead."""
        if max_chunk_chars is None:
            max_chunk_chars = default_chunk_chars(self.max_speech_len)
        chunks = split_text(text, max_chunk_chars)
        cap = max(self.batch_buckets)
        wavs: list[np.ndarray] = []
        for i in range(0, len(chunks), cap):
            wavs += self.synthesize(chunks[i : i + cap], speaker, seed=seed)
        return join_waveforms(wavs, self.sample_rate, crossfade_ms=crossfade_ms, gap_ms=gap_ms)

