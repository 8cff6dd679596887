"""The serving cells' comparison with the reference.

For each engine call the recorder kept, and for the rows of it that the
sample holds, the reference follows the call stage by stage from the
program's own state (the canvas of each t2s pass, the input of each s2a
pass) and judges what the program produced there:

- ``canvas``: positions where a t2s canvas differs from what the request
  and the program's own choices allow (the first canvas is the request's
  text with its length; later ones keep every position outside the speech
  span and hold [MASK] or a semantic id inside it). Exact.
- ``length_gap``: how far, in log frames, the reference's predicted
  length lies outside the interval the served length says
  (``ceil(exp(l))``); only for requests that carry no length.
- ``t2s_gap``: the widest gap by which a served semantic token lies below
  the reference's best: the sampled tokens of every pass under the
  sampler's own gumbel noise (worked out again from the request's seed),
  the last pass's argmax without noise.
- ``s2a_start``: relative error of the first s2a input against the
  reference's (the semantic embedding plus the mask token, behind the
  prompt's embedding and projected level-0 features).
- ``s2a_state``: the widest relative error of a later s2a input (every
  first-level pass after the first, and the full pass): at a generated
  position against the nearest of the reference's candidates there (still
  masked, or committed with one of the level-0 ids the program served
  before), at a prompt position against the reference's prompt embedding.
- ``s2a_gap``: the same gap for the level-0 ids of every first-level pass
  and for every level of the codes of the full pass (whose injections are
  the features of the program's own codes);
- ``t2s_gap_mean``, ``s2a_gap_mean``: those gaps' mean over every served
  token judged (0 where the program chose the reference's best), steadier
  from seed to seed than the widest;
- ``decode_err``: the worst row's relative l2 error of the returned
  waveform against the reference's decode of its codes at their exact
  length.
- ``answer``: rows whose waveform is missing or of the wrong length.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import model as ref
from portbench.reference.noise import gumbel_lanes, iteration_seeds

READINGS = ("canvas", "length_gap", "t2s_gap", "t2s_gap_mean", "s2a_start", "s2a_state",
            "s2a_gap", "s2a_gap_mean", "decode_err", "answer")


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative l2 error of each row's vectors ``(..., D)``."""
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-12)


def _gaps(logits: torch.Tensor, served: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """``max(logits) - logits[served]`` at the positions of ``where``; 0
    where the served token is the best (also where the noise puts +inf on
    it: a uniform that rounds to 1 in f32, on both sides alike)."""
    best = logits.max(-1)
    g = best.values - logits.gather(-1, served[..., None])[..., 0]
    return torch.where(best.indices == served, 0.0, g)[where]


class ServeCheck:
    """Accumulates the readings of every checked row (maxima)."""

    def __init__(self, cfg: dict, t2s_state: dict, s2a_state: dict, prompt_acoustic,
                 prompt_semantic, device):
        self.cfg = cfg
        q = cfg["serving"]["quantize"]
        self.pt = ref.Params(t2s_state, quantize="int8" if q in ("int8", "w8a8") else "none")
        self.ps = ref.Params(s2a_state, quantize="int8" if q in ("int8", "w8a8") else "none")
        self.pc = ref.Params(s2a_state)
        self.device = device
        self.prompt_acoustic = prompt_acoustic.to(device)
        self.prompt_semantic = prompt_semantic.to(device)
        self.readings = dict.fromkeys(READINGS, 0.0)
        self.rows = 0
        self.tokens = 0
        self._sums = {"t2s": [0.0, 0], "s2a": [0.0, 0]}

    def _put(self, name: str, value: float) -> None:
        self.readings[name] = max(self.readings[name], value)

    def _gap(self, stage: str, logits, served, where) -> None:
        g = _gaps(logits, served, where)
        if g.numel():
            self._put(f"{stage}_gap", float(g.max()))
            acc = self._sums[stage]
            acc[0] += float(g.double().sum())
            acc[1] += g.numel()
            self.readings[f"{stage}_gap_mean"] = acc[0] / acc[1]
            self.tokens += g.numel()

    def _state(self, x, candidates: list, enc_prompt, valid, tp: int) -> None:
        """``s2a_state`` of a later s2a input ``x``: its prompt positions
        against the prompt's embedding, its generated ones against the
        nearest candidate."""
        prompt = _rel(x[:, :tp], enc_prompt)
        gen = torch.stack([_rel(x[:, tp:], c) for c in candidates]).min(0).values
        self._put("s2a_state", max(float(prompt.max()), float(gen[valid].max())))

    def call(self, cap: dict, texts: list[str], gt: list[int] | None, waves: list, rows: list[int],
             seed: int) -> None:
        """Judge ``rows`` (indices into the call's real rows) of one call;
        what the program kept in a shape the request cannot have (so that
        judging it fails) counts the rows as wrong answers."""
        try:
            self._call(cap, texts, gt, waves, rows, seed)
        except (ValueError, IndexError, KeyError, RuntimeError) as e:
            print(f"check_serve: rows {rows} cannot be judged: {e!r}")
            self._put("answer", float(len(rows)))

    @torch.no_grad()
    def _call(self, cap, texts, gt, waves, rows, seed) -> None:
        t2c, sv = self.cfg["t2s"], self.cfg["serving"]
        dev = self.device
        idx = torch.tensor(rows, device=dev)
        text = [[b + 5 for b in texts[r].encode("utf-8")] for r in rows]
        canv0 = cap["canvases"][0]
        lt = canv0.shape[1] - 4 - sv["max_speech_len"]
        text_tok = torch.tensor([t[:lt] + [0] * (lt - len(t)) for t in text], device=dev)
        text_len = torch.tensor([len(t) for t in text], device=dev)
        lengths = cap["lengths"].to(dev)[idx].long()
        self.rows += len(rows)
        # answers: every row's waveform, trimmed to its length
        hop = ref.hop(self.cfg["codec"])
        bad = sum(1 for r in rows if waves[r] is None or len(waves[r]) != int(
            cap["lengths"][r]) * hop)
        self._put("answer", float(bad))

        # length
        if gt is None:
            log_len = ref.t2s_log_length(self.pt, t2c, text_tok,
                                         torch.arange(lt, device=dev)[None] < text_len[:, None])
            lo = torch.log((lengths - 1).clamp_min(1).float())
            hi = torch.log(lengths.float())
            gap = torch.maximum(lo - log_len, log_len - hi).clamp_min(0.0)
            gap = torch.where(lengths > 1, gap, (log_len - hi).clamp_min(0.0))
            self._put("length_gap", float(gap.max()))
        else:
            if not torch.equal(lengths.cpu(), torch.tensor([gt[r] for r in rows])):
                self._put("answer", float(len(rows)))

        # t2s
        canvas, attention, span = ref.build_canvas(text_tok, text_len, lengths,
                                                   sv["max_speech_len"])
        canvases = [c[idx] for c in cap["canvases"]]
        self._put("canvas", float((canvases[0] != canvas).sum()))
        off = t2c["text_vocab_size"] + 5
        vsem = t2c["semantic_vocab_size"]
        for c in canvases[1:]:
            outside = (~span & (c != canvas)).sum()
            inside = (span & (c != ref.SPECIAL["mask"]) & ((c < off) | (c >= off + vsem))).sum()
            self._put("canvas", float(outside + inside))
        t2s_seeds, s2a_seeds = iteration_seeds(seed, sv["pred_iters"] - 1, sv["s2a_steps"] - 1)
        n_pass = len(canvases)
        for i in range(n_pass):
            logits = ref.t2s_logits(self.pt, t2c, canvases[i], attention)
            if i < n_pass - 1:
                nxt = canvases[i + 1]
                pert = logits + gumbel_lanes(t2s_seeds[i][0], idx, logits.shape[1], vsem)
                served = (nxt - off).clamp(0, vsem - 1)
                where = span & (nxt != ref.SPECIAL["mask"])
                self._gap("t2s", pert, served, where)
                del pert
            else:
                t = cap["semantic"].shape[1]
                pos = 3 + text_len[:, None] + torch.arange(t, device=dev)[None]
                final = logits.gather(1, pos.clamp(max=logits.shape[1] - 1)[..., None].expand(
                    -1, -1, vsem))
                valid = torch.arange(t, device=dev)[None] < lengths[:, None]
                self._gap("t2s", final, cap["semantic"][idx], valid)
            del logits

        # s2a
        s2c, codec = self.cfg["s2a"], self.cfg["codec"]
        semantic = cap["semantic"][idx]
        t = semantic.shape[1]
        tp = self.prompt_semantic.shape[1]
        b = len(rows)
        valid = torch.arange(t, device=dev)[None] < lengths[:, None]
        pad_mask = torch.cat([torch.ones((b, tp), dtype=torch.bool, device=dev), valid], 1)
        feats_p = ref.codec_features(self.ps, codec, self.prompt_acoustic)  # (1, Q, Tp, D)
        sem = self.ps["semantic_embedding.weight"][semantic]
        enc_prompt = (self.ps["semantic_embedding.weight"][self.prompt_semantic]
                      + ref._feat_proj(self.ps, "acoustic_feat_proj", feats_p[:, 0]))
        masked = sem + self.ps["mask_token"]
        x0 = torch.cat([enc_prompt.expand(b, -1, -1), masked], 1)
        firsts = [x[idx].float() for x in cap["first_x"]]
        self._put("s2a_start", float(_rel(firsts[0], x0)[pad_mask].max()))
        ids = [i_[idx] for i_ in cap["commit_ids"]]
        candidates = [masked]
        for i, x in enumerate(firsts):
            if i:
                self._state(x, candidates, enc_prompt, valid, tp)
            logits = ref.s2a_first_level(self.ps, s2c, x, pad_mask)[:, tp:]
            if i < len(firsts) - 1:
                logits = logits + gumbel_lanes(s2a_seeds[i][0], idx, t, logits.shape[-1])
            self._gap("s2a", logits, ids[i], valid)
            proj = ref._feat_proj(self.ps, "acoustic_feat_proj",
                                  ref.codec_features(self.ps, codec, ids[i][:, None]).sum(1))
            candidates.append(sem + proj)
            del logits
        full_x = cap["full_x"][idx].float()
        self._state(full_x, candidates, enc_prompt, valid, tp)
        codes = cap["codes"][idx]
        n_inj = len(s2c["injection_layers"])
        cum_p = torch.cumsum(feats_p, 1)[:, :n_inj]
        cum_g = torch.cumsum(ref.codec_features(self.ps, codec, codes[:, :n_inj]), 1)
        injected = torch.cat([cum_p.expand(b, -1, -1, -1), cum_g], 2).transpose(0, 1)
        logits = ref.s2a_full_logits(self.ps, s2c, codec, full_x, injected, pad_mask, tp)
        self._gap("s2a", logits, codes, valid[:, None, :].expand(-1, codes.shape[1], -1))
        del logits, injected

        # decode
        for j, r in enumerate(rows):
            n = int(lengths[j])
            wave = ref.decode(self.pc, codec, codes[j:j + 1, :, :n])[0, :n * hop]
            got = torch.as_tensor(waves[r], device=dev).float()
            if got.shape == wave.shape:
                self._put("decode_err", float((got - wave).norm() / wave.norm().clamp_min(1e-12)))
            else:
                self._put("decode_err", math.inf)
