"""Tokenizer plumbing for the generative serving model.

The port's copy of `kubeflow_tpu/serve/tokenizer_util.py`: the bundled-
tokenizer probe and the ids/text resolution of `GenerativeTorchModel`.
A tokenizer is the string "bytes" (UTF-8 bytes as ids) or any HF-style
object with `encode`/`decode`; `transformers` is imported only inside
`load_bundled_tokenizer`.
"""

from __future__ import annotations

import os

#: Files whose presence marks an HF checkpoint dir as carrying its own
#: tokenizer (fast JSON, sentencepiece Llama-style, sentencepiece T5).
TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "spiece.model")


def load_bundled_tokenizer(ckpt: str, name: str):
    """AutoTokenizer from the checkpoint dir, or None (missing files or a
    failed load — logged, never fatal: the model still serves raw ids)."""
    if not any(os.path.exists(os.path.join(ckpt, f))
               for f in TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(ckpt)
    except Exception as e:
        print(f"tokenizer load skipped for {name}: {e}", flush=True)
        return None


def resolve_ids(tokenizer, payload: dict) -> list[int]:
    """'input_ids' | 'text' → non-empty token id list, or ValueError."""
    ids = payload.get("input_ids")
    text = payload.get("text")
    if ids is None and text is not None:
        if tokenizer == "bytes":
            ids = list(text.encode("utf-8"))
        elif hasattr(tokenizer, "encode"):  # HF-style tokenizer
            ids = list(tokenizer.encode(text))
        else:
            raise ValueError(
                "this model takes token ids ('input_ids'); no tokenizer "
                "is bundled")
    if ids is None:
        raise ValueError("request needs 'input_ids' (or 'text')")
    if not len(ids):
        raise ValueError("'input_ids'/'text' must be non-empty")
    return [int(i) for i in ids]


def decode_ids(tokenizer, ids: list[int]) -> str:
    if tokenizer == "bytes":
        return bytes(t for t in ids if 0 <= t < 256).decode(
            "utf-8", errors="replace")
    return tokenizer.decode(ids, skip_special_tokens=True)
