"""Device settings, keyed by the device kind JAX reports.

Every size that depends on the accelerator lives in ONE table here:

* ``max_agg``: the drain width (elements one fused sort/aggregate
  kernel sees; also the raw-buffer width, so it sets the drain cadence);
* ``spcr_index_rows``: the master-row count above which the sPCR index
  skips its count-packed probe plane and builds primer-scan rc indexes
  per scan instead of caching them.

The ``cpu`` entry holds the small sizes the tests and development runs
use. The H100 entry is sized from the memory the process may actually
allocate (``memory_stats()["bytes_limit"]``). A device kind that is not
in the table is an error: no entry is assumed.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class DeviceSettings:
    max_agg: int
    spcr_index_rows: int


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _cpu(_dev) -> DeviceSettings:
    return DeviceSettings(max_agg=1 << 22, spcr_index_rows=1 << 27)


def _h100(dev) -> DeviceSettings:
    limit = int(dev.memory_stats()["bytes_limit"])
    # A drain at width W holds the u64 buffer, the sorted copy, int32
    # positions and the compaction sort's operands: about 40 B/element
    # at peak. 2^27 is the largest width the count loop needs (one
    # drain per ~1M reads of 150 bp); keep it under a quarter of the
    # allocatable memory so the master and staged runs fit beside it.
    max_agg = min(1 << 27, _pow2_floor(limit // (4 * 40)))
    # The full sPCR index costs ~32 B/row beside the master's 12 B/row
    # (count-packed probe plane, 2D probe copies, cached rc index);
    # 128 B/row leaves room for scan and closure transients.
    return DeviceSettings(
        max_agg=max_agg, spcr_index_rows=_pow2_floor(limit // 128)
    )


# device_kind -> entry. Family keys match kinds that start with the
# key followed by a space ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe").
_TABLE = {
    "cpu": _cpu,
    "NVIDIA H100": _h100,
}

_cache: dict[str, DeviceSettings] = {}


def _entry(kind: str):
    for key, entry in _TABLE.items():
        if kind == key or kind.startswith(key + " "):
            return entry
    raise RuntimeError(
        f"no device settings for device kind {kind!r}; known kinds: "
        f"{sorted(_TABLE)}"
    )


def settings_for(dev) -> DeviceSettings:
    """The table entry for ``dev`` (raises for an unknown kind)."""
    return _entry(dev.device_kind)(dev)


def settings() -> DeviceSettings:
    """Settings of the default device, computed once per kind. Raises
    when the backend cannot initialise or the kind is unknown."""
    dev = jax.devices()[0]
    kind = dev.device_kind
    if kind not in _cache:
        _cache[kind] = settings_for(dev)
    return _cache[kind]


def describe() -> dict:
    """Platform, device kind and device count of the default backend.
    Raises when the backend cannot initialise."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
