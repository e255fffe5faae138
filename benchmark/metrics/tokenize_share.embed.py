"""Host seconds inside the tokenizer (the ``tokenize`` span the bulk-embed
generator records around ``HashTokenizer.batch``) over the window."""

UNIT, LAYER, MOVES = "%", "tokenizer", "embed_chunks_per_s"


def read(rec: dict):
    s = rec["spans"].get("tokenize")
    return None if s is None else 100.0 * s / rec["window_s"]
