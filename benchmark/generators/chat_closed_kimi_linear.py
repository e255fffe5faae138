"""RAG answers from a Kimi Linear model (KDA layers beside latent attention,
a share of the experts held) in a closed loop: ``chat_closed``'s callers,
window, release and trace segments, with the model built from its own
configuration and weights and compared with its own plain reference.

The model is ``pathway_tpu_torch.models.KimiLinearConfig`` from the
configuration's ``model`` keys (``kda_layers`` as a tuple, ``experts_held``
[start, stop) as a range), its weights ``benchmark/weights_kimi_linear.py``
from the seed, served by ``TorchLMChat`` over its continuous batcher.
After the window, the sampled requests and the longest are run through
``benchmark/reference/kimi_linear.py`` together, in f32 (and in fp8 for
the control); ``logit_gap_mean`` is read as ``chat_closed_mla_moe`` reads
it: random routing flips near-ties under bf16 here as there.

The prompts are ``corpus.prompts``' in its seeded order, dealt to the
callers as ``chat_closed`` deals them: a window holds some 55 prefills of
up to 16k tokens, a draw of the mix, and the draw moves the answer rate
from seed to seed (PERF.md).

With ``--trace 1`` the observability plane is on from the window's ramp,
as in ``chat_closed_mla_moe``, and each device operation is put in the
span its launch call ran in, by the trace's correlation ids
(:func:`layer_parts`): each traced decode step and each traced prefill
gives the record its span's attributes and its device seconds in
``lm.kda``, ``lm.mla``, ``lm.moe`` and in all of its launch
(``rec["part_steps"]``, ``rec["part_prefills"]``).
"""

from __future__ import annotations

import asyncio
import bisect
import dataclasses
import os
import time

import torch

from benchmark import corpus, weights, weights_kimi_linear
from benchmark.generators import chat_closed
from benchmark.reference import kimi_linear as ref
from benchmark.reference import tokenizer as ref_tok
from benchmark.roofline import busy_union
from benchmark.trace import CLOCK

PARTS = ("lm.kda", "lm.mla", "lm.moe")
PHASES = {"cb.step": "cb.step.launch", "cb.prefill": "cb.prefill.launch"}


def model_config(model: dict):
    """The port's config of a configuration file's ``model`` keys."""
    from pathway_tpu_torch.models import KimiLinearConfig

    keys = {f.name for f in dataclasses.fields(KimiLinearConfig)} - {"dtype"}
    kw = {k: model[k] for k in keys if k in model}
    kw.update(kda_layers=tuple(model["kda_layers"]), experts_held=range(*model["experts_held"]))
    return KimiLinearConfig(dtype=weights.torch_dtype(model["dtype"]), **kw)


def layer_parts(events, clock_ns: int, ring: list[dict], span_to_wall_ns: int) -> dict:
    """The traced decode steps and prefills, each with its span's
    attributes and the device seconds of the operations launched inside
    its ``lm.kda``, ``lm.mla`` and ``lm.moe`` spans (``kda_s``, ``mla_s``,
    ``moe_s``) and inside its whole ``.launch`` span (``total_s``):
    ``{"steps": [...], "prefills": [...]}``.

    Arguments as ``chat_closed_mla_moe.layer_steps`` takes them. A launch
    call (a host event with a correlation id) belongs to the spans that
    cover its start; a device operation belongs where its launch call
    does. A phase counts if its whole span lies inside the trace and no
    device operation whose launch the trace lacks ran among its own."""
    clock_at, launches, device = None, [], []
    t_lo = t_hi = None
    for ev in events:
        t_lo = ev.start_ns() if t_lo is None else min(t_lo, ev.start_ns())
        t_hi = ev.end_ns() if t_hi is None else max(t_hi, ev.end_ns())
        dev = str(ev.device_type()).endswith("CUDA")
        if ev.name() == CLOCK and not dev:
            clock_at = ev.start_ns()
        elif dev and not ev.is_user_annotation():
            device.append((ev.correlation_id(), ev.start_ns(), ev.end_ns()))
        elif not dev and ev.correlation_id() and ev.name().startswith("cu"):
            launches.append((ev.start_ns(), ev.correlation_id()))
    if clock_at is None or not device:
        return {"steps": [], "prefills": []}
    shift = clock_at - clock_ns + span_to_wall_ns  # span stamp -> trace clock
    by_id = {s["id"]: s for s in ring}
    phases = {}  # the phase span's id -> (its kind, its attributes, device intervals by part)
    for s in ring:
        if s["name"] in PHASES and t_lo <= s["start_ns"] + shift and s["end_ns"] + shift <= t_hi:
            phases[s["id"]] = (s["name"], s["attrs"], {p: [] for p in (*PARTS, "total")})
    parts, whole = [], []  # (start, end, part, phase id) on the trace's clock
    for s in ring:
        owner = by_id.get(s["parent"])
        if s["name"] in PHASES.values() and s["parent"] in phases:
            whole.append((s["start_ns"] + shift, s["end_ns"] + shift, "total", s["parent"]))
        elif s["name"] in PARTS and owner and owner["name"] in PHASES.values() and owner["parent"] in phases:
            parts.append((s["start_ns"] + shift, s["end_ns"] + shift, s["name"], owner["parent"]))
    owners = {}
    for spans in (parts, whole):
        spans.sort()
        starts = [p[0] for p in spans]
        for t, corr in launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                owners.setdefault(corr, []).append(spans[i])
    launched = {corr for _, corr in launches}
    orphans = sorted(s for corr, s, _ in device if corr not in launched)
    for corr, s, e in device:
        for part in owners.get(corr, ()):
            phases[part[3]][2][part[2]].append((s, e))
    out = {"steps": [], "prefills": []}
    for kind, attrs, ops in phases.values():
        if not ops["total"]:
            continue
        lo, hi = min(s for s, _ in ops["total"]), max(e for _, e in ops["total"])
        i = bisect.bisect_left(orphans, lo)
        if i < len(orphans) and orphans[i] < hi:
            continue  # an operation whose launch the trace lost: not split
        row = {**attrs, **{f"{p.removeprefix('lm.')}_s": busy_union(v) / 1e9 for p, v in ops.items()}}
        out["steps" if kind == "cb.step" else "prefills"].append(row)
    return out


class Run(chat_closed.Run):
    def __init__(self, model: dict, traffic: dict, seed: int, device, spans):
        from pathway_tpu_torch.xpacks.llm.embedders import bucket_len
        from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

        self.model, self.traffic, self.seed, self.device = model, traffic, seed, device
        t = time.perf_counter()
        self.prompts = corpus.prompts(traffic, seed)
        self.setup_phases = {"inputs_s": time.perf_counter() - t}
        cfg = model_config(model)
        self.budget = cfg.max_len - traffic["new_tokens"]
        if traffic["prompt_tokens"]["cap"] > self.budget:
            raise ValueError(f"prompts reach {traffic['prompt_tokens']['cap']} tokens, past the budget {self.budget}")
        self.chat = TorchLMChat(
            config=cfg, params=weights_kimi_linear.make(model, seed, device),
            max_new_tokens=traffic["new_tokens"], temperature=0.0, decode_slots=traffic["slots"],
            continuous_batching=True, device=device,
        )
        cb = self.chat._cb
        cb._step = spans.marked(cb._step, "decode_step", lambda: chat_closed.step_work(cb))
        cb._prefill = spans.marked(cb._prefill, "prefill")
        widths = {}
        for text, n in self.prompts:
            widths.setdefault(bucket_len(n, self.budget), text)
        self.setup_phases["program_s"] = time.perf_counter() - t - self.setup_phases["inputs_s"]
        t = time.perf_counter()
        asyncio.run(self._send_all(list(widths.values())))
        self.setup_phases["warm_s"] = time.perf_counter() - t
        self.records: list = []

    def window(self, seconds: float, tracer) -> dict:
        if tracer is None:
            return super().window(seconds, tracer)
        from pathway_tpu_torch.internals import observability as obs
        from pathway_tpu_torch.internals import spans as port_spans

        os.environ["PATHWAY_OBS_RING"] = str(self.traffic["obs_ring"])
        obs.enable()
        stop = tracer.stop
        taken = {}

        def stop_and_read() -> None:
            stop()
            taken.update(ring=port_spans.spans(), offset=port_spans.profiler_clock_offset_ns())

        tracer.stop = stop_and_read
        win = super().window(seconds, tracer)
        events = tracer.prof.profiler.kineto_results.events()
        split = layer_parts(events, tracer._clock_ns, taken["ring"], taken["offset"])
        win["rec"].update(part_steps=split["steps"], part_prefills=split["prefills"])
        return win

    def _reference(self) -> None:
        ref.no_tf32()
        self._params = weights_kimi_linear.make(self.model, self.seed, self.device)
        self._logits = None
        m = self.model
        self._seqs = []
        for text, served in self.sample:
            ids = ref_tok.tokenize(text, m["vocab_size"], m["max_len"])[-self.budget:]
            self._seqs.append((ids + served[:-1], len(ids) - 1, served))

    def _gap(self, fp8: bool) -> float:
        """The mean, over the served positions of the sampled requests, of
        the gap by which a served token's f32 reference logit lies below
        the reference's best; with `fp8`, of the tokens the fp8 control
        puts first."""
        seqs = [s for s, _, _ in self._seqs]
        firsts = [f for _, f, _ in self._seqs]
        with torch.no_grad():
            if self._logits is None:  # the f32 pass, once for both readings
                self._logits = ref.lm_logits(self._params, seqs, self.model, firsts)
            lgs = self._logits
            picks = [torch.tensor(served, device=lg.device) for lg, (_, _, served) in zip(lgs, self._seqs)]
            if fp8:
                picks = [lg.argmax(-1) for lg in ref.lm_logits(self._params, seqs, self.model, firsts, fp8=True)]
        gaps = []
        for lg, pick in zip(lgs, picks, strict=True):
            if pick.shape[0] != lg.shape[0]:
                return float("inf")
            gaps.append(lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0])
        return float(torch.cat(gaps).mean())

    def check(self) -> dict:
        self._reference()
        return {"logit_gap_mean": self._gap(False)}

    def control(self) -> dict:
        return {"logit_gap_mean": self._gap(True)}
