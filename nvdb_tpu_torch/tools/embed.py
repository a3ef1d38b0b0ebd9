"""Text -> embedding vecbin, the build_vecbin_chunked.py analogue: the port
of ``nvdb_tpu.tools.embed``. A CSV / JSONL / plain-text corpus is chunked by
sentence, each chunk embedded by a transformer (mean-pooled,
L2-normalized), and the rows streamed into a vecbin64, with an optional
``rowmeta.jsonl`` sidecar.

    python -m nvdb_tpu_torch.tools.embed corpus.jsonl out.vecbin --model PATH \\
        [--text-field text] [--max-chars 1000] [--batch 64] [--meta meta.jsonl] \\
        [--device cuda|cpu]

It needs a model already on the machine (a local path or a name in the
HuggingFace cache): nothing is downloaded. Without one it exits 3.
``transformers`` is imported only then, so the chunking runs without it.
"""

from __future__ import annotations

import json
import re

import numpy as np

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def chunk_text(text: str, max_chars: int = 1000) -> list[str]:
    """Sentence-aware chunking into pieces of at most ``max_chars`` (the
    reference's scheme, build_vecbin_chunked.py:189-225): sentences
    accumulate; one sentence longer than ``max_chars`` is split hard."""
    chunks: list[str] = []
    cur = ""
    for sent in _SENT_SPLIT.split(text.strip()):
        if not sent:
            continue
        if len(sent) > max_chars:
            if cur:
                chunks.append(cur)
                cur = ""
            for s in range(0, len(sent), max_chars):
                chunks.append(sent[s:s + max_chars])
            continue
        if len(cur) + len(sent) + 1 > max_chars and cur:
            chunks.append(cur)
            cur = sent
        else:
            cur = f"{cur} {sent}".strip()
    if cur:
        chunks.append(cur)
    return chunks


def _iter_texts(path: str, text_field: str):
    """The documents of a ``.jsonl`` / ``.csv`` file (their ``text_field``)
    or of a plain-text file (one a line)."""
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                yield str(json.loads(line).get(text_field, ""))
    elif path.endswith(".csv"):
        import csv

        with open(path, newline="") as f:
            for rec in csv.DictReader(f):
                yield str(rec.get(text_field, ""))
    else:
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("corpus", help=".jsonl / .csv / plain-text lines")
    p.add_argument("out")
    p.add_argument("--model", default="sentence-transformers/all-MiniLM-L6-v2",
                   help="local path or HF-cached model name")
    p.add_argument("--text-field", default="text")
    p.add_argument("--max-chars", type=int, default=1000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--meta", default=None, help="rowmeta.jsonl sidecar path")
    args = p.parse_args(argv)

    try:
        from transformers import AutoModel, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.model, local_files_only=True)
        model = AutoModel.from_pretrained(args.model, local_files_only=True)
    except Exception as e:  # no network: the model must be on the machine
        fail(f"model {args.model!r} unavailable locally ({e}); nothing is downloaded "
             "— pass --model with a local path", 3)
    import torch

    device = setup_device(args)
    model = model.to(device).eval()
    dim = model.config.hidden_size
    meta_f = open(args.meta, "w") if args.meta else None
    n = 0
    batch: list[str] = []
    try:
        with vecbin.StreamingVecbinWriter(args.out, dim, "f32") as w:
            def flush():
                nonlocal n
                if not batch:
                    return
                enc = tok(batch, padding=True, truncation=True, max_length=256,
                          return_tensors="pt").to(device)
                with torch.no_grad():
                    out = model(**enc).last_hidden_state          # [B, L, H]
                mask = enc["attention_mask"].unsqueeze(-1).float()
                emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1)
                emb = torch.nn.functional.normalize(emb, dim=1).cpu().numpy()
                w.append(np.ascontiguousarray(emb, dtype=np.float32))
                n += len(batch)
                batch.clear()

            for doc_i, text in enumerate(_iter_texts(args.corpus, args.text_field)):
                for ch_i, chunk in enumerate(chunk_text(text, args.max_chars)):
                    batch.append(chunk)
                    if meta_f:
                        meta_f.write(json.dumps({"doc": doc_i, "chunk": ch_i,
                                                 "chars": len(chunk)}) + "\n")
                    if len(batch) >= args.batch:
                        flush()
            flush()
    finally:
        if meta_f:
            meta_f.close()
    print(f"embedded {n} chunks x {dim} -> {args.out}")
    return n


if __name__ == "__main__":
    main()
