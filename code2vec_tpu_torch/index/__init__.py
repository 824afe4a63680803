"""The embedding index: k-NN search over code vectors — the port of
``code2vec_tpu/index/`` (INDEX.md). It closes the loop extract -> train
-> export -> search:

- ``store``   — the on-disk memory-mapped vector store (+ labels), the
  reference's format byte for byte;
- ``exact``   — brute-force k-NN on the device (a blocked product and
  top-k), plus the streamed tier for stores larger than device memory;
- ``ivf``     — k-means coarse quantizer, inverted lists, ``nprobe``
  probing;
- ``quant``   — int8/PQ codes over the IVF lists with a host-exact top-R
  re-rank, live insert segments and compaction;
- ``service`` — build/load/query, and the records behind the serving
  engine's ``submit_neighbors``.
"""
from code2vec_tpu_torch.index.store import VectorStore

__all__ = ['VectorStore']
