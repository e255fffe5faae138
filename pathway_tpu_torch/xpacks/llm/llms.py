"""Chat wrappers — LLMs as UDFs on tables.

Counterpart of ``pathway_tpu/xpacks/llm/llms.py``: ``BaseChat`` (a
``pw.UDF`` whose async ``__wrapped__(messages)`` returns the answer) and
the port's own model chat ``TorchLMChat``, the counterpart of
``JaxLMChat``: the same defaults, tokenizer, buckets and output format
(``"<id> <id> ..."``), generating on the card. The provider chats
(``OpenAIChat``, ``LiteLLMChat``, ``CohereChat``) and the local
HuggingFace pipeline (``HFPipelineChat``, on the card by default) are
the JAX package's, each importing its provider's package when built.
"""

from __future__ import annotations

import functools
import weakref
from typing import TYPE_CHECKING, Any

import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.device_plane import DevicePlane, get_device_plane
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.models import build_lm, family_of, transformer
from pathway_tpu_torch.models.deepseek import DeepseekConfig
from pathway_tpu_torch.models.kimi_linear import KimiLinearConfig
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    generate_serving,
    init_kv_cache,
    lm_config,
)
from pathway_tpu_torch.xpacks.llm.embedders import pad_left_rows

if TYPE_CHECKING:
    from pathway_tpu_torch.serving.continuous_batching import ContinuousBatcher


def _prep_message_log(messages: Any, verbose: bool) -> str:
    if verbose:
        return repr(messages)
    return repr(messages)[:500]


def prompt_chat_single_qa(question: str) -> Json:
    """Wrap a plain question into the single-turn chat message format."""
    return Json([{"role": "user", "content": question}])


class BaseChat(pw.UDF):
    """Common chat surface: __wrapped__(messages, **kwargs) -> str."""

    kwargs: dict[str, Any]

    def __init__(
        self,
        *,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        **chat_kwargs: Any,
    ):
        executor = udfs.async_executor(
            capacity=capacity, retry_strategy=retry_strategy
        )
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.kwargs = dict(chat_kwargs)

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return True

    def __call__(self, messages: ColumnExpression, **kwargs: Any) -> ColumnExpression:
        return super().__call__(messages, **kwargs)


class OpenAIChat(BaseChat):
    """OpenAI chat-completions (reference: llms.py:84). Requires the
    `openai` package and network access; construction fails fast otherwise."""

    def __init__(self, model: str | None = "gpt-4o-mini", **kwargs: Any):
        super().__init__(**kwargs)
        self.kwargs["model"] = model
        try:
            import openai
        except ImportError as e:
            raise ImportError(
                "OpenAIChat requires the `openai` package; use TorchLMChat for "
                "generation on the card or mocks.FakeChatModel in tests"
            ) from e
        self.client = openai.AsyncOpenAI()  # shared pool across rows

    async def __wrapped__(self, messages: Any, **kwargs: Any) -> str | None:
        msgs = messages.value if isinstance(messages, Json) else messages
        merged = {**self.kwargs, **kwargs}
        ret = await self.client.chat.completions.create(messages=msgs, **merged)
        return ret.choices[0].message.content


class LiteLLMChat(BaseChat):
    """LiteLLM multi-provider chat (reference: llms.py:313)."""

    def __init__(self, model: str | None = None, **kwargs: Any):
        super().__init__(**kwargs)
        self.kwargs["model"] = model
        try:
            import litellm  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "LiteLLMChat requires the `litellm` package; use TorchLMChat for "
                "generation on the card"
            ) from e

    async def __wrapped__(self, messages: Any, **kwargs: Any) -> str | None:
        import litellm

        msgs = messages.value if isinstance(messages, Json) else messages
        merged = {**self.kwargs, **kwargs}
        ret = await litellm.acompletion(messages=msgs, **merged)
        return ret.choices[0].message.content


class CohereChat(BaseChat):
    """Cohere chat with citations (reference: llms.py:544)."""

    def __init__(self, model: str | None = "command", **kwargs: Any):
        super().__init__(**kwargs)
        self.kwargs["model"] = model
        try:
            import cohere
        except ImportError as e:
            raise ImportError(
                "CohereChat requires the `cohere` package; use TorchLMChat for "
                "generation on the card"
            ) from e
        self.client = cohere.AsyncClient()  # shared pool across rows

    async def __wrapped__(
        self, messages: Any, documents: Any = None, **kwargs: Any
    ) -> tuple:
        msgs = messages.value if isinstance(messages, Json) else messages
        client = self.client
        merged = {**self.kwargs, **kwargs}
        docs = (
            [d.value if isinstance(d, Json) else d for d in documents]
            if documents
            else None
        )
        message = msgs[-1]["content"]
        chat_history = msgs[:-1]
        ret = await client.chat(
            message=message, chat_history=chat_history, documents=docs, **merged
        )
        cited = [
            {"text": c.text, "start": c.start, "end": c.end}
            for c in (ret.citations or [])
        ]
        return ret.text, cited


class HFPipelineChat(BaseChat):
    """Local HuggingFace text-generation pipeline (reference: llms.py:441),
    on the card unless `device` says otherwise; TorchLMChat is the port's
    own model chat."""

    def __init__(
        self,
        model: str | None = "gpt2",
        call_kwargs: dict | None = None,
        device: str = "cuda",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        try:
            from transformers import pipeline
        except ImportError as e:
            raise ImportError(
                "HFPipelineChat requires `transformers`; use TorchLMChat for "
                "generation on the card"
            ) from e
        self.pipeline = pipeline("text-generation", model=model, device=device)
        self.tokenizer = self.pipeline.tokenizer
        self.call_kwargs = call_kwargs or {}

    def crop_to_max_length(self, input_string: str, max_prompt_length: int = 500) -> str:
        tokens = self.tokenizer.tokenize(input_string)
        if len(tokens) > max_prompt_length:
            tokens = tokens[-max_prompt_length:]
        return self.tokenizer.convert_tokens_to_string(tokens)

    def __wrapped__(self, messages: Any, **kwargs: Any) -> str | None:
        msgs = messages.value if isinstance(messages, Json) else messages
        if isinstance(msgs, list):
            prompt = "\n".join(m["content"] for m in msgs)
        else:
            prompt = str(msgs)
        merged = {**self.call_kwargs, **kwargs}
        merged.setdefault("max_new_tokens", 64)
        merged.setdefault("return_full_text", False)
        out = self.pipeline(prompt, **merged)
        return out[0]["generated_text"]


class TorchLMChat(BaseChat):
    """Generation on the card (or on `device`) with one of the port's
    causal LMs, chosen by the config's type (``models.family_of``): the
    GPT-2-style ``TransformerConfig`` (the default, ``lm_config``), the
    DeepSeek-V3 ``DeepseekConfig`` (latent attention and routed experts)
    or the Kimi Linear ``KimiLinearConfig`` (KDA layers and their
    recurrent state beside latent attention, a share of the experts held).

    Pass `params` (e.g. from ``models.convert.params_from_numpy``) for a
    given model; without them the weights are random from `generator`
    (default seed 0).

    Dispatch: continuous batching by default at temperature 0 — requests
    join an in-flight decode batch at step boundaries through the slot
    scheduler (``serving/continuous_batching.py``). ``PATHWAY_CONTINUOUS_BATCH=0``,
    ``continuous_batching=False`` or any ``temperature > 0`` use the
    wave-aligned coalescer instead: one left-padded ``generate_serving``
    per wave, the same tokens per request at temperature 0. The
    DeepSeek-V3 and Kimi Linear families serve through the slot scheduler
    only: they raise ``NotImplementedError`` for the wave-aligned path and
    for sampling.
    """

    def __init__(
        self,
        config: TransformerConfig | DeepseekConfig | KimiLinearConfig | None = None,
        params: Params | None = None,
        tokenizer: Any = None,
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        max_batch: int = 64,
        continuous_batching: bool | None = None,
        decode_slots: int = 8,
        *,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.config = config or lm_config(
            vocab_size=32768, d_model=256, n_heads=8, n_layers=4, d_ff=1024, max_len=512,
        )
        if max_new_tokens >= self.config.max_len:
            raise ValueError(
                f"max_new_tokens ({max_new_tokens}) must be smaller than the "
                f"model context length ({self.config.max_len})"
            )
        # imported here: the serving package imports this xpack's helpers
        from pathway_tpu_torch.serving.continuous_batching import (
            ContinuousBatcher,
            continuous_batching_on,
        )

        if continuous_batching is None:
            continuous_batching = continuous_batching_on()
        if family_of(self.config) is not transformer and not (continuous_batching and temperature == 0.0):
            raise NotImplementedError(
                f"{type(self.config).__name__} serves greedy answers through continuous batching "
                "only (no wave-aligned path, no sampling)"
            )
        self.model = build_lm(self.config, params, device=device, generator=generator)
        self.params = self.model.params
        self.device = self.model.device
        self.tokenizer = tokenizer or HashTokenizer(
            vocab_size=self.config.vocab_size, max_len=self.config.max_len
        )
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.max_batch = max_batch
        # a wave of concurrent calls left-pads into one generate dispatch
        # (prompt_mask keeps each row's tokens those of an unpadded run);
        # the KV cache is a persistent buffer per row bucket (a lease)
        self._plane = get_device_plane()
        self._gen = self._plane.program(
            self._plane.unique_name("lm_generate"),
            functools.partial(
                generate_serving, n_steps=max_new_tokens, cfg=self.config, temperature=temperature
            ),
        )
        self._batcher = self._plane.coalescer(self._generate_batch, max_batch=max_batch)
        self._cb: ContinuousBatcher | None = None
        if continuous_batching and temperature == 0.0:
            self._cb = ContinuousBatcher(
                params=self.params, cfg=self.config, tokenizer=self.tokenizer,
                n_steps=max_new_tokens, n_slots=decode_slots, plane=self._plane,
            )
        # the plane is process-wide: without this, every dead chat would
        # pin its programs and KV caches for the life of the process
        self._finalizer = weakref.finalize(
            self, _release_chat_programs, self._plane, self._gen.name, self._cb,
        )

    @torch.no_grad()
    def _generate_batch(self, prompts: list[str]) -> list[str]:
        budget = self.config.max_len - self.max_new_tokens
        rows = [self.tokenizer.tokenize(p)[-budget:] for p in prompts]
        n = max(min(self._plane.buckets.rows_bucket(len(rows)), self.max_batch), len(rows))
        ids, mask = pad_left_rows(rows, budget, n_rows=n)
        bucket = ids.shape[1]
        generator = None
        if self.temperature > 0.0:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(abs(hash(tuple(prompts))) % (1 << 31))
        cache_key = ("lm_kv_cache", self._gen.name, n)
        cache = self._plane.lease(cache_key, lambda: init_kv_cache(self.config, n, self.device))
        try:
            out, cache = self._gen(
                self.params, torch.from_numpy(ids).to(self.device), cache,
                prompt_mask=torch.from_numpy(mask).to(self.device), generator=generator,
                bucket=(n, bucket),
            )
            out = out.cpu().numpy()
        finally:
            self._plane.restore(cache_key, cache)
        return [" ".join(f"<{int(t)}>" for t in out[i, bucket:]) for i in range(len(rows))]

    def batcher_stats(self) -> dict[str, float] | None:
        """A copy of the continuous batcher's counters (``stats``: counts
        and host seconds, each a number; ``serving/continuous_batching.py``),
        or None on the wave-aligned path."""
        return dict(self._cb.stats) if self._cb is not None else None

    async def __wrapped__(self, messages: Any, **kwargs: Any) -> str:
        import asyncio

        msgs = messages.value if isinstance(messages, Json) else messages
        if isinstance(msgs, list):
            prompt = "\n".join(m["content"] for m in msgs)
        else:
            prompt = str(msgs)
        if self._cb is not None:
            return await asyncio.wrap_future(self._cb.submit(prompt))
        return await self._batcher.submit(prompt)


def _release_chat_programs(
    plane: DevicePlane, gen_name: str, cb: ContinuousBatcher | None
) -> None:
    """Finalizer body for TorchLMChat: module-level, so the weakref holds
    no bound method that refers back to the instance."""
    plane.drop_program(gen_name)
    if cb is not None:
        cb.close()
