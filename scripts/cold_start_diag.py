"""Fresh-process cold-start diagnosis: where do the seconds go when
every kernel is a persistent-cache HIT?

Times each first-call stage of the count path separately, plus backend
init and data upload, so a fresh process's start-up cost can be
attributed (tracing vs cache load vs executable upload vs data
transfer vs device run).

Usage: python scripts/cold_start_diag.py
"""
import os
import sys
import time

T0 = time.perf_counter()


def stamp(msg):
    print(f"[{time.perf_counter()-T0:7.2f}s] {msg}", file=sys.stderr,
          flush=True)


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402

stamp("numpy imported")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

stamp("jax imported")
import sharkmer_tpu  # noqa: E402  (configures cache, x64)

d = jax.devices()[0]
stamp(f"backend init ({d.platform} {d.device_kind})")

import logging

events = []


class _H(logging.Handler):
    def emit(self, record):
        msg = record.getMessage()
        if "cache hit" in msg or "compilation cache" in msg:
            events.append((round(time.perf_counter() - T0, 2), msg[:90]))


lg = logging.getLogger("jax._src.compiler")
lg.setLevel(logging.DEBUG)
lg.addHandler(_H())

sys.argv = ["x", "--quick"] if "--quick" in sys.argv else ["x"]
import bench as B  # noqa: E402

args = B.build_parser().parse_args([])
stamp("generating 1M reads (host)")
codes_all = B.make_reads_codes(args.reads, args.read_len, args.genome_mbp,
                               panel=args.panel, error_rate=args.error_rate)
stamp("reads generated")

from sharkmer_tpu.ops.sorted_store import SortedKmerStore  # noqa: E402

store = SortedKmerStore.create(args.k)
n_batches = -(-args.reads // args.batch)
t = time.perf_counter()
b0 = jnp.asarray(codes_all[: args.batch])
b0.block_until_ready()
stamp(f"first batch upload ({args.batch*args.read_len/1e6:.0f} MB): "
      f"{time.perf_counter()-t:.2f}s")

t = time.perf_counter()
store.ingest_codes(b0)
stamp(f"first ingest_codes (encode+append compile/load): "
      f"{time.perf_counter()-t:.2f}s")

for b in range(1, n_batches):
    store.ingest_codes(jnp.asarray(
        codes_all[b * args.batch:(b + 1) * args.batch]))
stamp("remaining ingests dispatched")

t = time.perf_counter()
store.flush()
stamp(f"flush/drain (first drain kernel): {time.perf_counter()-t:.2f}s")

t = time.perf_counter()
h = store.histogram(10_000)
stamp(f"histogram: {time.perf_counter()-t:.2f}s (n={int(np.sum(h))})")

stamp(f"total; cache events: {len(events)}")
for ts, msg in events:
    print(f"   {ts:7.2f}s {msg}", file=sys.stderr)
