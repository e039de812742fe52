"""``InMemoryIndex`` on the configuration's corpus, made from the seed on
the device in whole blocks and added through one page-locked buffer in
chunks (``add`` takes numpy arrays)."""

import time

import numpy as np
import torch

from bench_port import data

#: rows a corpus ``add`` ships: whole blocks, 3.2 GB of fp32 at dim 768
ADD_ROWS = 16 * data.BLOCK_ROWS


def build(config: dict, seed: int, encoder, device: torch.device, log=print):
    """The index and its number of rows."""
    from fastforward_tpu_torch import InMemoryIndex, Mode

    docs = data.corpus_layout(seed, config)
    n_rows = config["passages"]
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
    staging = torch.empty((min(ADD_ROWS, n_rows), config["dim"]), dtype=torch.float32,
                          pin_memory=device.type == "cuda")
    made = added = 0.0
    for lo in range(0, n_rows, ADD_ROWS):
        hi = min(n_rows, lo + ADD_ROWS)
        mark = time.perf_counter()
        vectors = staging[: hi - lo]
        vectors.copy_(data.corpus_rows(seed, lo, hi, n_rows, config["dim"], device))
        vectors = vectors.numpy()
        ids = data.id_strings(prefix, np.arange(lo, hi) if docs is None else doc_of_row[lo:hi])
        made += time.perf_counter() - mark
        mark = time.perf_counter()
        if docs is None:
            index.add(vectors, psg_ids=ids)
        else:
            index.add(vectors, doc_ids=ids)
        added += time.perf_counter() - mark
        del vectors
    log(f"[setup] corpus made and copied out {made:.2f} s, added {added:.2f} s")
    return index, n_rows
