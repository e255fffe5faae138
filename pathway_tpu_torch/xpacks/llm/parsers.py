"""Document parsers: bytes -> list[(text, metadata)].

Reference parity: xpacks/llm/parsers.py — `ParseUtf8` (:53),
`ParseUnstructured` (:79), `OpenParse` (:235), `ImageParser` (:396),
`SlideParser` (:569), `PypdfParser` (:746). The heavyweight backends
(unstructured/openparse/vision LLMs) are optional imports; `ParseUtf8` is
dependency-free and `PypdfParser` works when `pypdf` is importable.
"""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch as pw


class ParseUtf8(pw.UDF):
    """Decode bytes as UTF-8, one document chunk (reference: parsers.py:53)."""

    def __init__(self) -> None:
        super().__init__(deterministic=True)

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        if isinstance(contents, bytes):
            text = contents.decode("utf-8", errors="replace")
        else:
            text = str(contents)
        return [(text, {})]


# reference alias
Utf8Parser = ParseUtf8


class ParseUnstructured(pw.UDF):
    """unstructured.io-based parsing of arbitrary file types
    (reference: parsers.py:79). Requires the `unstructured` package."""

    def __init__(self, mode: str = "single", **unstructured_kwargs: Any):
        super().__init__()
        try:
            import unstructured.partition.auto  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ParseUnstructured requires `unstructured`; ParseUtf8 handles "
                "plain text without extra dependencies"
            ) from e
        if mode not in ("single", "elements", "paged"):
            raise ValueError(f"mode must be single|elements|paged, got {mode!r}")
        self.mode = mode
        self.kwargs = unstructured_kwargs

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        import io

        from unstructured.partition.auto import partition

        elements = partition(file=io.BytesIO(contents), **{**self.kwargs, **kwargs})
        if self.mode == "single":
            return [("\n\n".join(str(e) for e in elements), {})]
        out = []
        for e in elements:
            meta = e.metadata.to_dict() if hasattr(e, "metadata") else {}
            meta["category"] = getattr(e, "category", None)
            out.append((str(e), meta))
        return out


class PypdfParser(pw.UDF):
    """PDF text extraction via pypdf (reference: parsers.py:746)."""

    def __init__(self, apply_text_cleanup: bool = True):
        super().__init__()
        try:
            import pypdf  # noqa: F401
        except ImportError as e:
            raise ImportError("PypdfParser requires `pypdf`") from e
        self.apply_text_cleanup = apply_text_cleanup

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        import io

        import pypdf

        reader = pypdf.PdfReader(io.BytesIO(contents))
        out = []
        for i, page in enumerate(reader.pages):
            text = page.extract_text() or ""
            if self.apply_text_cleanup:
                text = " ".join(text.split())
            out.append((text, {"page": i}))
        return out


def _sniff_mime(contents: bytes) -> str:
    if contents.startswith(b"\x89PNG"):
        return "image/png"
    if contents.startswith(b"\xff\xd8"):
        return "image/jpeg"
    if contents.startswith((b"GIF87a", b"GIF89a")):
        return "image/gif"
    if contents[:4] == b"RIFF" and contents[8:12] == b"WEBP":
        return "image/webp"
    return "application/octet-stream"


def _encode_image(
    contents: bytes, downsize_width: int | None, fmt: str = "JPEG"
) -> tuple[str, str]:
    """Returns (base64 payload, mime type); downsizes via PIL when the
    image is wider than `downsize_width`. Without PIL the original bytes
    pass through with their sniffed mime type."""
    import base64
    import io

    try:
        from PIL import Image
    except ImportError:
        return base64.b64encode(contents).decode(), _sniff_mime(contents)
    mime = "image/jpeg" if fmt.upper() in ("JPEG", "JPG") else "image/png"
    img = Image.open(io.BytesIO(contents))
    if downsize_width and img.width > downsize_width:
        ratio = downsize_width / img.width
        img = img.resize((downsize_width, max(1, int(img.height * ratio))))
    buf = io.BytesIO()
    img.convert("RGB").save(buf, format=fmt.upper().replace("JPG", "JPEG"))
    return base64.b64encode(buf.getvalue()).decode(), mime


def _vision_messages(prompt: str, b64: str, mime: str) -> list[dict]:
    """OpenAI-style multimodal content parts (the format the reference's
    vision parse functions build, _parser_utils.py)."""
    return [
        {
            "role": "user",
            "content": [
                {"type": "text", "text": prompt},
                {
                    "type": "image_url",
                    "image_url": {"url": f"data:{mime};base64,{b64}"},
                },
            ],
        }
    ]


class ImageParser(pw.UDF):
    """Parse images by describing them with a vision LLM.

    Reference parity: parsers.py:396 — the image is (optionally) downsized
    with PIL, base64-encoded into OpenAI-style multimodal messages, and
    described by `llm`; with `detail_parse_schema` (a dict JSON schema or
    a pydantic model) a second call extracts structured fields into the
    doc metadata.
    """

    def __init__(
        self,
        llm: Any,
        parse_prompt: str = "Describe the image contents concisely.",
        detail_parse_schema: Any = None,
        downsize_horizontal_width: int = 1920,
        include_schema_in_text: bool = False,
        max_image_size: int = 15 * 1024 * 1024,
        **kwargs: Any,
    ):
        super().__init__()
        self.llm = llm
        self.parse_prompt = parse_prompt
        self.detail_parse_schema = detail_parse_schema
        self.downsize_width = downsize_horizontal_width
        self.include_schema_in_text = include_schema_in_text
        self.max_image_size = max_image_size

    def _call_llm(self, messages: list[dict]) -> str:
        import asyncio
        import inspect

        fn = self.llm.__wrapped__
        result = fn(messages)
        if inspect.iscoroutine(result):
            # run on the engine's shared loop thread — no per-call loop
            from pathway_tpu_torch.engine.runtime import _get_async_loop

            result = asyncio.run_coroutine_threadsafe(
                result, _get_async_loop()
            ).result()
        return result or ""

    def _schema_json(self) -> str:
        import json as _json

        schema = self.detail_parse_schema
        if hasattr(schema, "model_json_schema"):  # pydantic v2 model
            schema = schema.model_json_schema()
        return _json.dumps(schema)

    def _parse_one(self, contents: bytes) -> tuple[str, dict]:
        if len(contents) > self.max_image_size:
            raise ValueError(
                f"image of {len(contents)} bytes exceeds max_image_size"
            )
        b64, mime = _encode_image(contents, self.downsize_width)
        text = self._call_llm(_vision_messages(self.parse_prompt, b64, mime))
        meta: dict = {}
        if self.detail_parse_schema is not None:
            import json as _json

            raw = self._call_llm(
                _vision_messages(
                    "Extract the following fields from the image as a JSON "
                    f"object matching this schema: {self._schema_json()}. "
                    "Reply with JSON only.",
                    b64,
                    mime,
                )
            )
            try:
                meta["parsed"] = _json.loads(raw.strip().strip("`").lstrip("json"))
            except ValueError:
                meta["parsed_raw"] = raw
            if self.include_schema_in_text and "parsed" in meta:
                text = f"{text}\n{_json.dumps(meta['parsed'])}"
        return text, meta

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        return [self._parse_one(contents)]


class SlideParser(ImageParser):
    """Parse PDF slide decks page-by-page with a vision LLM.

    Reference parity: parsers.py:569. Decks are rendered to images via
    PyMuPDF (fitz) when installed, scaled toward `image_size`, and each
    page goes through the ImageParser flow with page-numbered metadata.
    PPTX input requires a pptx→pdf converter upstream (the reference
    shells out to LibreOffice for this) and raises a clear error here.
    """

    def __init__(
        self,
        llm: Any,
        parse_prompt: str = "Describe the slide contents concisely.",
        detail_parse_schema: Any = None,
        intermediate_image_format: str = "jpg",
        image_size: tuple[int, int] = (1280, 720),
        **kwargs: Any,
    ):
        super().__init__(
            llm,
            parse_prompt=parse_prompt,
            detail_parse_schema=detail_parse_schema,
            downsize_horizontal_width=image_size[0],
            **kwargs,
        )
        self.intermediate_image_format = intermediate_image_format
        self.image_size = image_size

    def _render_pages(self, contents: bytes) -> list[bytes]:
        if contents[:2] == b"PK":  # zip container: pptx/odp
            raise ValueError(
                "SlideParser: PPTX/ODP input needs converting to PDF first "
                "(e.g. libreoffice --convert-to pdf); only PDF decks are "
                "rendered directly"
            )
        try:
            import fitz  # PyMuPDF
        except ImportError as e:
            raise ImportError(
                "SlideParser requires PyMuPDF (fitz) to render slides to "
                "images; it is not installed in this environment"
            ) from e
        doc = fitz.open(stream=contents, filetype="pdf")
        pages = []
        for page in doc:
            # scale rendering toward the requested slide width
            scale = self.image_size[0] / max(page.rect.width, 1.0)
            pix = page.get_pixmap(matrix=fitz.Matrix(scale, scale))
            pages.append(pix.tobytes(self.intermediate_image_format))
        return pages

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        out = []
        for i, page_bytes in enumerate(self._render_pages(contents)):
            text, meta = self._parse_one(page_bytes)
            out.append((text, {**meta, "page": i}))
        return out
