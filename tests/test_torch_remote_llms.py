"""The provider chats and embedders of the port against the JAX package's.

``OpenAIChat``, ``LiteLLMChat``, ``CohereChat``, ``HFPipelineChat``,
``OpenAIEmbedder``, ``LiteLLMEmbedder``, ``GeminiEmbedder`` and
``SentenceTransformerEmbedder`` call their provider's package. Here fake
``openai``, ``litellm``, ``cohere``, ``google.generativeai``,
``transformers`` and ``sentence_transformers`` modules in ``sys.modules``
answer with canned replies computed from the request, so nothing is
downloaded and no network is used: both packages' classes, run as UDFs
through ``pw.run()`` on one small table, must return the same values.
With each provider's module blocked, each class raises ``ImportError``.
"""

import importlib
import sys
import types
import zlib

import numpy as np
import pytest

from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu_torch.internals.parse_graph import G as PORT_G

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
QUESTIONS = ["alpha", "beta gamma", "how long is a 500-token chunk?"]
# class -> (module, the provider modules it imports, constructor arguments)
CLASSES = {
    "OpenAIChat": ("llms", ("openai",), {}),
    "LiteLLMChat": ("llms", ("litellm",), {"model": "fake/chat"}),
    "CohereChat": ("llms", ("cohere",), {}),
    "HFPipelineChat": ("llms", ("transformers",), {}),
    "OpenAIEmbedder": ("embedders", ("openai",), {}),
    "LiteLLMEmbedder": ("embedders", ("litellm",), {"model": "fake/embed"}),
    "GeminiEmbedder": ("embedders", ("google.generativeai",), {}),
    "SentenceTransformerEmbedder": ("embedders", ("sentence_transformers",), {"model": "fake-st"}),
}
# what each port class names instead, when its provider is missing
PORT_MODEL = {"llms": "TorchLMChat", "embedders": "TorchEmbedder"}


@pytest.fixture(autouse=True)
def _clear_graphs():
    JAX_G.clear()
    PORT_G.clear()
    yield
    JAX_G.clear()
    PORT_G.clear()


def _vector(text: str, model: str) -> list[float]:
    """A canned embedding: a few numbers computed from the request."""
    h = zlib.crc32(f"{model}|{text}".encode())
    return [float(len(text)), float(h % 997), float((h >> 10) % 991) / 7.0]


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _fake_modules(calls: list) -> dict[str, types.ModuleType]:
    """The six provider modules, each answering from its arguments and
    recording how it was built in `calls`."""
    openai = types.ModuleType("openai")

    class AsyncOpenAI:
        def __init__(self):
            async def create_chat(messages, model, **kw):
                content = f"openai {model}: {messages[-1]['content']}"
                return _ns(choices=[_ns(message=_ns(content=content))])

            async def create_embedding(input, model, **kw):
                return _ns(data=[_ns(embedding=_vector(input[0], model))])

            self.chat = _ns(completions=_ns(create=create_chat))
            self.embeddings = _ns(create=create_embedding)

    openai.AsyncOpenAI = AsyncOpenAI

    litellm = types.ModuleType("litellm")

    async def acompletion(messages, model, **kw):
        return _ns(choices=[_ns(message=_ns(content=f"litellm {model}: {messages[-1]['content']}"))])

    async def aembedding(input, model, **kw):
        return _ns(data=[{"embedding": _vector(input[0], model)}])

    litellm.acompletion, litellm.aembedding = acompletion, aembedding

    cohere = types.ModuleType("cohere")

    class AsyncClient:
        async def chat(self, message, chat_history, documents, model, **kw):
            cite = _ns(text=message[:5], start=0, end=min(5, len(message)))
            return _ns(text=f"cohere {model}: {message} ({len(chat_history)})", citations=[cite])

    cohere.AsyncClient = AsyncClient

    genai = types.ModuleType("google.generativeai")
    genai.embed_content = lambda content, model, **kw: {"embedding": _vector(content, model)}

    transformers = types.ModuleType("transformers")

    class Pipeline:
        def __init__(self, task, model, device):
            calls.append(("transformers.pipeline", task, model, device))
            self.model = model
            self.tokenizer = _ns(tokenize=str.split, convert_tokens_to_string=" ".join)

        def __call__(self, prompt, max_new_tokens, return_full_text, **kw):
            return [{"generated_text": f"{self.model} +{max_new_tokens}: {prompt[::-1]}"}]

    transformers.pipeline = Pipeline

    st = types.ModuleType("sentence_transformers")

    class SentenceTransformer:
        def __init__(self, model, device, **kw):
            calls.append(("sentence_transformers.SentenceTransformer", model, device))
            self.model = model

        def encode(self, text, **kw):
            return np.asarray(_vector(text, self.model), np.float32)

    st.SentenceTransformer = SentenceTransformer
    return {
        "openai": openai, "litellm": litellm, "cohere": cohere, "google.generativeai": genai,
        "transformers": transformers, "sentence_transformers": st,
    }


@pytest.fixture
def fakes(monkeypatch):
    calls: list = []
    for name, mod in _fake_modules(calls).items():
        monkeypatch.setitem(sys.modules, name, mod)
    genai = sys.modules["google.generativeai"]
    try:
        import google
    except ImportError:
        monkeypatch.setitem(sys.modules, "google", types.ModuleType("google"))
        google = sys.modules["google"]
    monkeypatch.setattr(google, "generativeai", genai, raising=False)
    return calls


def _run(pkg: str, cls: str) -> dict:
    """`cls` of `pkg` as a UDF over a small table through pw.run(): the
    result of each question (chats get it as a single-turn message)."""
    pw = importlib.import_module(pkg)
    module, _, kwargs = CLASSES[cls]
    mod = importlib.import_module(f"{pkg}.xpacks.llm.{module}")
    udf = getattr(mod, cls)(**kwargs)
    t = pw.debug.table_from_rows(pw.schema_from_types(q=str), [(q,) for q in QUESTIONS])
    if module == "llms":
        arg = pw.apply(mod.prompt_chat_single_qa, t.q)
    else:
        arg = t.q
    out = t.select(q=t.q, r=udf(arg))
    got: dict = {}
    pw.io.subscribe(out, on_change=lambda key, row, time, is_addition: got.__setitem__(row["q"], row["r"]))
    pw.run()
    return got


def _plain(value):
    """A UDF's result as plain Python, whichever package's Json wraps it."""
    value = getattr(value, "value", value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


@pytest.mark.parametrize("cls", list(CLASSES))
def test_provider_class_matches_the_jax_package(fakes, cls):
    ref = _run("pathway_tpu", cls)
    JAX_G.clear()
    got = _run("pathway_tpu_torch", cls)
    assert sorted(got) == sorted(ref) == sorted(QUESTIONS)
    for q in QUESTIONS:
        assert _plain(got[q]) == _plain(ref[q]), (cls, q, got[q], ref[q])
        assert got[q] is not None


@pytest.mark.parametrize("cls", ["HFPipelineChat", "SentenceTransformerEmbedder"])
def test_local_models_default_to_the_card(fakes, cls):
    """The port's entry points run on the card unless the caller asks for
    the CPU; the JAX package's local models default to the CPU."""
    module, _, kwargs = CLASSES[cls]
    for pkg, device in (("pathway_tpu", "cpu"), ("pathway_tpu_torch", "cuda")):
        fakes.clear()
        getattr(importlib.import_module(f"{pkg}.xpacks.llm.{module}"), cls)(**kwargs)
        assert fakes[0][-1] == device, (pkg, fakes)
    fakes.clear()
    getattr(importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{module}"), cls)(**kwargs, device="cpu")
    assert fakes[0][-1] == "cpu"


@pytest.mark.parametrize("cls", list(CLASSES))
def test_provider_class_without_its_package_raises(monkeypatch, cls):
    """With the provider's module blocked, both packages' classes raise
    ImportError when built; the port's names its own model class."""
    module, providers, kwargs = CLASSES[cls]
    for name in providers:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        getattr(importlib.import_module(f"pathway_tpu.xpacks.llm.{module}"), cls)(**kwargs)
    with pytest.raises(ImportError, match=PORT_MODEL[module]):
        getattr(importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{module}"), cls)(**kwargs)
