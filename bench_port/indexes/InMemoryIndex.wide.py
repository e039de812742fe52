"""``InMemoryIndex`` on the configuration's corpus for wide rows: each
corpus block (``data.BLOCK_ROWS`` rows) is made on the device, copied out
through one page-locked buffer and added on its own.  At 4,096 fp32 a
block is 1.07 GB, so the build's transient on the card is one block
beside the table and the tower (``InMemoryIndex.py`` makes and
concatenates 16 blocks a chunk)."""

import time

import numpy as np
import torch

from bench_port import data


def build(config: dict, seed: int, encoder, device: torch.device, log=print):
    """The index and its number of rows."""
    from fastforward_tpu_torch import InMemoryIndex, Mode

    docs = data.corpus_layout(seed, config)
    n_rows, dim = config["passages"], config["dim"]
    index = InMemoryIndex(
        query_encoder=encoder,
        mode=Mode.PASSAGE if config["mode"] == "passage" else Mode.MAXP,
        encoder_batch_size=config["encoder_batch_size"],
        init_size=n_rows,
        store=config["store"],
        precision=config["precision"],
        device=device,
    )
    doc_of_row = None if docs is None else np.repeat(np.arange(docs.counts.size), docs.counts)
    prefix = data.id_prefix(config)
    staging = torch.empty((min(data.BLOCK_ROWS, n_rows), dim), dtype=torch.float32,
                          pin_memory=device.type == "cuda")
    made = added = 0.0
    for block in range(-(-n_rows // data.BLOCK_ROWS)):
        lo = block * data.BLOCK_ROWS
        hi = min(n_rows, lo + data.BLOCK_ROWS)
        mark = time.perf_counter()
        vectors = staging[: hi - lo]
        vectors.copy_(data.corpus_block(seed, block, n_rows, dim, device))
        ids = data.id_strings(prefix, np.arange(lo, hi) if docs is None else doc_of_row[lo:hi])
        made += time.perf_counter() - mark
        mark = time.perf_counter()
        if docs is None:
            index.add(vectors.numpy(), psg_ids=ids)
        else:
            index.add(vectors.numpy(), doc_ids=ids)
        added += time.perf_counter() - mark
    log(f"[setup] corpus made and copied out {made:.2f} s, added {added:.2f} s")
    return index, n_rows
