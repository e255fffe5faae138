"""RAG answers from a local model in a closed loop through
``TorchLMChat.__wrapped__`` over its continuous batcher.

``clients`` callers each send a prompt, await its answer, and send the
next, as a pipeline stage with a bounded number of questions in flight.
They join one a decode step (the batcher's ``decode_steps`` counter), so
that each step boundary admits about one request and completions stay
spread evenly over an answer's steps, however long a step takes: every
answer has the same length, so callers that started together would
admit and finish together for the whole run. The window opens
``settle_s`` after the last join. Prompts (``benchmark/corpus.py``) hold
a question and 2 to 4 retrieved chunks under a template; their token
counts are the stratified lognormal quantiles of ``prompt_tokens``,
heavy-tailed and cut at the model's budget. Greedy decoding
(temperature 0) of ``new_tokens`` tokens each. Set-up also sends one
prompt of each prefill width the mix can reach, and wraps the batcher's
step and prefill programs in :meth:`~benchmark.trace.Spans.marked`, so
that a trace splits the device's timeline into decode steps and
prefills.

Only callers' sends stop when the window closes: every request sent in
it is awaited and timed. With ``--trace 1`` the profiler runs over the
``trace_seconds`` after the window, under the same load (once more if
that profiler run recorded no device operation). After it,
``check.requests`` of the requests sent in the window, drawn from the
seed, and the one with the longest prompt, are run through the plain
reference in f32 over their prompts and served tokens: ``logit_gap`` is
the widest gap by which a served token's reference logit lies below the
reference's best at its position.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import torch

from benchmark import corpus, roofline, weights
from benchmark.reference import tokenizer as ref_tok
from benchmark.reference import transformer as ref


def served_tokens(answer: str) -> list[int]:
    """The token ids of TorchLMChat's answer string ("<id> <id> ...")."""
    return [int(t.strip("<>")) for t in answer.split()]


def step_work(cb) -> tuple[int, int]:
    """The rows of the decode step the batcher is about to take, and the
    real keys before their new tokens: a row's prompt and the tokens it
    has decoded. Read on the batcher's thread, which alone changes its
    slots."""
    active = list(cb._active.values())
    return len(active), sum(r.length + r.steps_done for r in active)


class Run:
    def __init__(self, model: dict, traffic: dict, seed: int, device, spans):
        from pathway_tpu_torch.models import lm_config
        from pathway_tpu_torch.xpacks.llm.embedders import bucket_len
        from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

        self.model, self.traffic, self.seed, self.device = model, traffic, seed, device
        t = time.perf_counter()
        self.prompts = corpus.prompts(traffic, seed)
        self.setup_phases = {"inputs_s": time.perf_counter() - t}
        kw = {k: model[k] for k in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_len")}
        cfg = lm_config(dtype=weights.torch_dtype(model["dtype"]), **kw)
        self.budget = cfg.max_len - traffic["new_tokens"]
        if traffic["prompt_tokens"]["cap"] > self.budget:
            raise ValueError(f"prompts reach {traffic['prompt_tokens']['cap']} tokens, past the budget {self.budget}")
        self.chat = TorchLMChat(
            config=cfg, params=weights.make(model, seed, device),
            max_new_tokens=traffic["new_tokens"], temperature=0.0, decode_slots=traffic["slots"],
            continuous_batching=True, device=device,
        )
        # the batcher's programs, marked for the trace: a decode step with
        # its rows and their real keys before the new token, a prefill
        cb = self.chat._cb
        cb._step = spans.marked(cb._step, "decode_step", lambda: step_work(cb))
        cb._prefill = spans.marked(cb._prefill, "prefill")
        # one prompt of each prefill width the mix reaches
        widths = {}
        for text, n in self.prompts:
            widths.setdefault(bucket_len(n, self.budget), text)
        self.setup_phases["program_s"] = time.perf_counter() - t - self.setup_phases["inputs_s"]
        t = time.perf_counter()
        asyncio.run(self._send_all(list(widths.values())))
        self.setup_phases["warm_s"] = time.perf_counter() - t
        self.records: list = []

    async def _ask(self, text: str) -> str:
        return await self.chat.__wrapped__([{"role": "user", "content": text}])

    async def _send_all(self, texts: list[str]) -> None:
        await asyncio.gather(*(self._ask(t) for t in texts))

    @property
    def stats(self) -> dict:
        return dict(self.chat._cb.stats)

    def window(self, seconds: float, tracer) -> dict:
        return asyncio.run(self._window(seconds, tracer))

    async def _window(self, seconds: float, tracer) -> dict:
        t = self.traffic
        clients = t["clients"]
        stop = {"at": None}
        records = self.records  # (sent, done, prompt index, answer or None)

        async def client(i: int) -> None:
            k = i
            while stop["at"] is None or time.perf_counter() < stop["at"]:
                idx = k % len(self.prompts)
                k += clients
                sent = time.perf_counter()
                try:
                    answer = await self._ask(self.prompts[idx][0])
                except Exception:  # noqa: BLE001 — a failed request counts as missing
                    answer = None
                records.append((sent, time.perf_counter(), idx, answer))

        ramp = time.perf_counter()
        tasks = []
        for i in range(clients):
            tasks.append(asyncio.create_task(client(i)))
            step = self.stats["decode_steps"]
            give_up = time.perf_counter() + t["drain_timeout_s"]
            while self.stats["decode_steps"] <= step:
                if time.perf_counter() > give_up:
                    raise RuntimeError("the batcher took no decode step while callers joined")
                await asyncio.sleep(0.001)
        self.setup_phases["ramp_s"] = time.perf_counter() - ramp
        await asyncio.sleep(t["settle_s"])
        t0 = time.perf_counter()
        # with a trace, the load goes on past the window while the profiler
        # runs, so that neither its cost nor its stop lands inside the
        # window the counters are read over
        if tracer is None:
            stop["at"] = t0 + seconds
        s0 = self.stats
        await asyncio.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        s1 = self.stats
        if tracer is not None:
            for _ in range(2):  # a profiler run that recorded no device operation is taken again
                tracer.start()
                await asyncio.sleep(t["trace_seconds"])
                tracer.stop()
                if tracer.device_events():
                    break
            stop["at"] = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(*tasks), timeout=t["drain_timeout_s"])

        new = t["new_tokens"]
        sent_in = [r for r in records if t0 <= r[0] < t1]
        done_in = [r for r in records if t0 <= r[1] < t1 and r[3] is not None]
        tokens = sum(len(served_tokens(r[3])) for r in done_in)
        lat = [(r[1] - r[0]) if r[3] is not None else float("inf") for r in sent_in]
        p95 = roofline.percentile_ms(lat, 95)
        failed = sum(r[3] is None or len(served_tokens(r[3])) != new for r in sent_in)
        self.window_bounds = (t0, t1)
        return {
            "t0": t0,
            "e2e": {
                "answer_tokens_per_s": tokens / (t1 - t0),
                "answer_p95_ms": p95 if p95 != float("inf") else None,
            },
            "rec": {
                "window_s": t1 - t0,
                "new_tokens": new,
                # (sent, done) relative to the window's start, prompt tokens
                "requests": [
                    (r[0] - t0, r[1] - t0, self.prompts[r[2]][1]) for r in records
                    if r[3] is not None and r[1] > t0 and r[0] < t1
                ],
                "stats": {k: s1[k] - s0[k] for k in s1},
            },
            "attempted": len(sent_in),
            "failed": int(failed),
        }

    def release(self) -> None:
        t0, t1 = self.window_bounds
        sent_in = [r for r in self.records if t0 <= r[0] < t1 and r[3] is not None]
        rng = np.random.default_rng([self.seed, 4])
        k = min(self.traffic["check"]["requests"], len(sent_in))
        picked = {int(i) for i in rng.choice(len(sent_in), size=k, replace=False)}
        picked.add(max(range(len(sent_in)), key=lambda i: self.prompts[sent_in[i][2]][1]))
        self.sample = [(self.prompts[sent_in[i][2]][0], served_tokens(sent_in[i][3])) for i in sorted(picked)]
        del self.chat

    def _reference(self) -> None:
        ref.no_tf32()
        self._params = weights.to_f32(weights.make(self.model, self.seed, self.device))
        m = self.model
        self._seqs = []
        for text, served in self.sample:
            ids = ref_tok.tokenize(text, m["vocab_size"], m["max_len"])[-self.budget:]
            self._seqs.append((ids + served[:-1], len(ids) - 1, served))

    def _gap(self, fp8: bool) -> float:
        """Widest gap below the f32 reference's best logit of the served
        tokens, or with `fp8` of the tokens the fp8 control puts first."""
        worst = 0.0
        with torch.no_grad():
            for seq, first, served in self._seqs:
                lg = ref.lm_logits(self._params, seq, self.model["n_heads"])[first:]
                if fp8:
                    pick = ref.lm_logits(self._params, seq, self.model["n_heads"], fp8=True)[first:].argmax(-1)
                else:
                    pick = torch.tensor(served, device=lg.device)
                if pick.shape[0] != lg.shape[0]:
                    return float("inf")
                gap = lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]
                worst = max(worst, float(gap.max()))
        return worst

    def check(self) -> dict:
        self._reference()
        return {"logit_gap": self._gap(False)}

    def control(self) -> dict:
        return {"logit_gap": self._gap(True)}
