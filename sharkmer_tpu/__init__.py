"""sharkmer_tpu — k-mer counting and in silico PCR on an accelerator.

A JAX/XLA re-design of the capabilities of caseywdunn/sharkmer
(reference v3.1.0):

1. Canonical k-mer counting with 2-bit rolling encoding
   (reference: src/kmer/encoding.rs:332, src/kmer/counting.rs:113).
   Here: reads are fixed-width uint8 code batches; a vectorised window
   encoder emits canonical k-mers, which a sort-based device count
   store aggregates (ops/encoding.py, ops/sorted_store.py).

2. Incremental ("chunked") counting with per-chunk histogram snapshots
   (reference: src/io.rs:977-1161). Here: reads are grouped by
   round-robin chunk id, ingested chunk by chunk, and the histogram is
   snapshotted from the device table.

3. In silico PCR (sPCR): primer-seeded de Bruijn graph extension over
   the count table (reference: src/pcr/). Here: the graph lives on
   host (python dicts — graphs are <=500k nodes), while every hot
   lookup (primer scans, reachability prefetch of the walk's
   neighbourhood) is a batched device kernel against the count table
   (pcr/, ops/reach.py).

The count table shards across a `jax.sharding.Mesh` for multi-device
runs (parallel/): inserts route to the owning shard, histograms merge
with psum, lookups fan out shard-local and combine.

Device-dependent sizes come from one table keyed by device kind
(device.py). JAX x64 must be enabled before any jax import downstream
of this package (k-mers are 2k-bit values packed in uint64, k <= 31).
"""

import os

import jax

# k-mers are packed 2 bits/base into uint64 (k <= 31 -> up to 62 bits).
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR
# itself when it is set; otherwise the cache lives at one fixed path
# inside the checkout (the path is part of what makes a later run hit).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"
