"""RAG answers from a DeepSeek-V3-family model (latent attention, routed
experts) in a closed loop: ``chat_closed``'s callers, window, release
and trace segments, with the model built from its own configuration and
weights and compared with its own plain reference.

The model is ``pathway_tpu_torch.models.DeepseekConfig`` from the
configuration's ``model`` keys, its weights ``benchmark/weights_mla_moe.py``
from the seed, served by ``TorchLMChat`` over its continuous batcher.
After the window, the sampled requests and the longest are run through
``benchmark/reference/mla_moe.py`` together, one layer at a time, in f32
(and in fp8 for the control). ``logit_gap_mean`` is the mean, over their
served positions, of the gap whose widest ``chat_closed`` reads: with
random weights a router's near-ties flip under bf16 rounding and a
flipped token's logits part from the reference's, so the widest gap of a
sound run reaches the fp8 control's, and the mean does not (PERF.md).

With ``--trace 1`` the observability plane is on from the window's ramp
with a span ring of the mix's ``obs_ring`` (``PATHWAY_OBS_RING``), so that
the model's ``lm.mla`` and ``lm.moe`` spans of the traced seconds stay in
it. The ring is read as the profiler stops. Each device operation is put
in the span its launch call ran in, by the trace's correlation ids
(:func:`layer_steps`), and each traced decode step gives the record its
rows, real keys, expert counters and its device seconds in each part
(``rec["layer_steps"]``).
"""

from __future__ import annotations

import asyncio
import bisect
import dataclasses
import os
import time

import torch

from benchmark import corpus, weights, weights_mla_moe
from benchmark.generators import chat_closed
from benchmark.reference import mla_moe as ref
from benchmark.reference import tokenizer as ref_tok
from benchmark.roofline import busy_union
from benchmark.trace import CLOCK

PARTS = ("lm.mla", "lm.moe")


def model_config(model: dict):
    """The port's config of a configuration file's ``model`` keys."""
    from pathway_tpu_torch.models import DeepseekConfig

    keys = {f.name for f in dataclasses.fields(DeepseekConfig)} - {"dtype"}
    return DeepseekConfig(dtype=weights.torch_dtype(model["dtype"]), **{k: model[k] for k in keys})


def layer_steps(events, clock_ns: int, ring: list[dict], span_to_wall_ns: int) -> list[dict]:
    """The traced decode steps, each with its span's attributes (rows,
    keys, the expert counters) and the device seconds of the operations
    launched inside its ``lm.mla`` and its ``lm.moe`` spans.

    `events` are the profiler's kineto events, `clock_ns` the host's
    ``time.time_ns`` at the ``bench/clock`` annotation, `ring` the plane's
    spans and `span_to_wall_ns` what puts a span stamp on ``time.time_ns``
    (``spans.profiler_clock_offset_ns``). A launch call (a host event with
    a correlation id) belongs to the layer span that covers its start; a
    device operation belongs where its launch call does. A step counts if
    its whole span lies inside the trace and no device operation whose
    launch the trace lacks ran among its own."""
    clock_at, launches, device = None, [], []
    t_lo = t_hi = None  # the trace's first and last stamps
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
        return []
    shift = clock_at - clock_ns + span_to_wall_ns  # span stamp -> trace clock
    by_id = {s["id"]: s for s in ring}
    steps, parts = {}, []
    for s in ring:
        if s["name"] == "cb.step" and t_lo <= s["start_ns"] + shift and s["end_ns"] + shift <= t_hi:
            steps[s["id"]] = {**s["attrs"], **{p: [] for p in PARTS}}
    for s in ring:
        if s["name"] in PARTS:
            launch = by_id.get(s["parent"])
            step = launch and launch["name"] == "cb.step.launch" and launch["parent"]
            if step in steps:
                parts.append((s["start_ns"] + shift, s["end_ns"] + shift, s["name"], step))
    parts.sort()
    starts = [p[0] for p in parts]
    owner = {}
    for t, corr in launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= parts[i][1]:
            owner[corr] = parts[i]
    launched = {corr for _, corr in launches}
    orphans = sorted(s for corr, s, _ in device if corr not in launched)
    for corr, s, e in device:
        part = owner.get(corr)
        if part is not None:
            steps[part[3]][part[2]].append((s, e))
    out = []
    for st in steps.values():
        ops = st[PARTS[0]] + st[PARTS[1]]
        if not ops:
            continue
        # a step in whose device time an operation ran whose launch the
        # trace lost (a dropped record) cannot be split: it is left out
        lo, hi = min(s for s, _ in ops), max(e for _, e in ops)
        i = bisect.bisect_left(orphans, lo)
        if i < len(orphans) and orphans[i] < hi:
            continue
        out.append({**{k: v for k, v in st.items() if k not in PARTS},
                    **{f"{p[3:]}_s": busy_union(st[p]) / 1e9 for p in PARTS}})
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
            config=cfg, params=weights_mla_moe.make(model, seed, device),
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
        win["rec"]["layer_steps"] = layer_steps(events, tracer._clock_ns, taken["ring"], taken["offset"])
        return win

    def _reference(self) -> None:
        ref.no_tf32()
        self._params = weights_mla_moe.make(self.model, self.seed, self.device)
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
