"""Per-step collective-traffic analysis (counterpart of
``paddle_tpu/distributed/comm_analysis.py``).

The reference parses the HLO of its compiled SPMD step: every collective
XLA emitted, its payload and the mesh axes its replica groups span. The
port compiles no program, so the step itself is the source:
``collective.record_collectives()`` records each collective this rank
issues while it runs (``collective.py``), one dict per call with the
reference's keys

    kind, payload_bytes, group_size, axes, wire_bytes_per_device,
    wire_dtype

plus ``bucket`` (the gradient-exchange bucket it belongs to, else None),
``issued`` (the call made, where the record names the reduction it
implements: the quantized gradient wire gathers its payload and sums it
on each rank) and ``ranks`` (the group's global ranks). Kinds and dtypes
take the HLO names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``, ``all-to-all``; ``f32``, ``bf16``, ``s8`` ...);
a broadcast is recorded as ``broadcast``.

The summaries (:func:`bucket_traffic`, :func:`axis_traffic_summary`,
:func:`axis_wire_summary`, :func:`axis_payload_summary`) are the
reference's, pure Python over such dicts, unchanged.
:func:`collective_traffic` and :func:`slice_crossing_traffic` take the
recorded step in place of HLO text.

Known differences (ROADMAP.md §C): the records are what the port issued
eagerly, one per call, not what a compiler fused, and the gradient
exchange's bucket count is ``grad_comm.build_buckets``'s.
"""
from __future__ import annotations

from typing import Dict, List

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}


def wire_model_bytes(kind: str, payload: int, n: int) -> int:
    """The reference's modeled per-device wire bytes (ring algorithms):
    all-reduce ``2 (n-1)/n p``, reduce-scatter ``(n-1)/n p n`` (``p`` the
    shard out), collective-permute ``p``, all-gather / all-to-all /
    broadcast ``(n-1)/n p``."""
    if kind == "all-reduce":
        return int(2 * (n - 1) / n * payload)
    if kind == "reduce-scatter":
        return int((n - 1) / n * payload * n)
    if kind == "collective-permute":
        return int(payload)
    return int((n - 1) / n * payload)


def collective_traffic(records: List[Dict]) -> List[Dict]:
    """The recorded step's collectives over more than one rank
    (``collective.record_collectives``), as the reference's list: each
    with ``kind``, ``payload_bytes``, ``group_size``, ``axes``,
    ``wire_bytes_per_device`` and ``wire_dtype``."""
    return [dict(r) for r in records if r["group_size"] > 1]


def axes_of_ranks(ranks, mesh) -> tuple:
    """The names of the mesh axes along which ``ranks``' coordinates
    vary; ``("unknown",)`` when the mesh does not hold every rank,
    ``("self",)`` for one rank."""
    coords = [mesh.coordinate(r) for r in ranks]
    if any(c is None for c in coords):
        return ("unknown",)
    axes = tuple(name for k, name in enumerate(mesh.dim_names)
                 if len({c[k] for c in coords}) > 1)
    return axes if axes else ("self",)


_GRAD_EXCHANGE_KINDS = ("all-reduce", "reduce-scatter")


def bucket_traffic(colls: List[Dict],
                   data_axes: tuple = ("dp", "sharding")) -> Dict:
    """Attribute the gradient exchange to its fusion buckets.

    A "bucket" is one reduction collective (all-reduce or reduce-scatter)
    whose replica groups span only data axes — exactly what grad_comm
    emits one of per fusion buffer (an unbucketed program shows one per
    parameter instead, which is the regression this report exists to
    catch). Returns per-bucket records plus the aggregate wire payload and
    its f32-equivalent, so reduced-precision wires are visible as
    ``payload_bytes < payload_bytes_f32`` (quantized_fraction > 0)."""
    data = set(data_axes)
    buckets = []
    for c in colls:
        axes = set(c["axes"]) - {"self"}
        if c["kind"] in _GRAD_EXCHANGE_KINDS and axes and axes <= data:
            buckets.append(c)
    payload = sum(c["payload_bytes"] for c in buckets)
    itemsize = {c["wire_dtype"]: _DTYPE_BYTES.get(c["wire_dtype"] or "f32", 4)
                for c in buckets}
    payload_f32 = sum(
        c["payload_bytes"] * 4 // itemsize[c["wire_dtype"]] for c in buckets)
    return {
        "buckets": buckets,
        "n_buckets": len(buckets),
        "payload_bytes": payload,
        "payload_bytes_f32": payload_f32,
        "quantized_fraction": (
            1.0 - payload / payload_f32 if payload_f32 else 0.0),
        "per_axis": axis_payload_summary(buckets),
    }


def axis_traffic_summary(colls: List[Dict]) -> Dict[str, int]:
    """Total modeled per-device wire bytes per mesh-axis combination."""
    agg: Dict[str, int] = {}
    for c in colls:
        key = "+".join(c["axes"])
        agg[key] = agg.get(key, 0) + c["wire_bytes_per_device"]
    return agg


def axis_wire_summary(colls: List[Dict]) -> Dict[str, Dict]:
    """Per axis-combination wire-dtype split — the activation-collective
    analogue of ``bucket_traffic``'s dp-bucket accounting. For every axis
    combo: payload bytes as they cross the wire, their f32 equivalent
    (what the same exchange would move unquantized), the quantized
    fraction, and the wire dtypes seen. mp_comm's blocked recombination
    shows up here as s8/bf16 payload on mp-involving axes; an exact
    program shows quantized_fraction == 0 everywhere."""
    agg: Dict[str, Dict] = {}
    for c in colls:
        key = "+".join(c["axes"])
        e = agg.setdefault(key, {
            "payload_bytes": 0, "payload_bytes_f32": 0,
            "wire_bytes_per_device": 0, "wire_dtypes": []})
        it = _DTYPE_BYTES.get(c["wire_dtype"] or "f32", 4)
        e["payload_bytes"] += c["payload_bytes"]
        e["payload_bytes_f32"] += c["payload_bytes"] * 4 // it
        e["wire_bytes_per_device"] += c["wire_bytes_per_device"]
        if c["wire_dtype"] and c["wire_dtype"] not in e["wire_dtypes"]:
            e["wire_dtypes"].append(c["wire_dtype"])
    for e in agg.values():
        p32 = e["payload_bytes_f32"]
        e["quantized_fraction"] = (
            1.0 - e["payload_bytes"] / p32 if p32 else 0.0)
    return agg


def axis_payload_summary(colls: List[Dict]) -> Dict[str, int]:
    """Total raw payload bytes per axis combination (pre-algorithm): what
    a hierarchical multi-slice schedule would move across the slice cut
    once per phase."""
    agg: Dict[str, int] = {}
    for c in colls:
        key = "+".join(c["axes"])
        agg[key] = agg.get(key, 0) + c["payload_bytes"]
    return agg


def slice_crossing_traffic(records: List[Dict],
                           slice_of_rank: Dict[int, int]) -> List[Dict]:
    """The recorded collectives whose group spans more than one slice
    (``slice_of_rank``: global rank -> slice id; a rank it lacks is slice
    0): ``kind``, ``payload_bytes``, ``group_size``, ``axes``."""
    out = []
    for r in records:
        ranks = r.get("ranks") or ()
        if len({slice_of_rank.get(x, 0) for x in ranks}) > 1:
            out.append({k: r[k] for k in ("kind", "payload_bytes",
                                          "group_size", "axes")})
    return out


__all__ = ["axes_of_ranks", "axis_payload_summary", "axis_traffic_summary",
           "axis_wire_summary", "bucket_traffic", "collective_traffic",
           "slice_crossing_traffic", "wire_model_bytes"]
