"""Static memory footprint of the engine's exchange and step.

The port's counterpart of the JAX package's ``scripts/footprint_probe.py``,
with its procedure, flags, defaults and JSON line.  Prints ONE JSON line
with the blob bytes per replica (the compact ``D`` layout against the
pre-compact all-int32 layout), the engine state bytes, and a peak
step-transient estimate for a given (G, W, K, R): arithmetic over the
engine's leaf tables, so a CPU run can check the card-memory budget
without a card.

    python -m gigapaxos_tpu_torch.testing.footprint [--groups G] [--window W]
        [--req-lanes K] [--replicas R] [--sharded N]
        [--steps-per-dispatch N] [--paused N]

Defaults are the headline bench shape (G=1,048,576, W=32, K=16, R=3).

``--steps-per-dispatch N`` adds the device-resident I/O ring bytes of the
unified step at ENGINE_STEPS_PER_DISPATCH=N: the request ring stages N x
[R, G, K] vid slabs and the response ring holds N packed [R, out_vec_len]
rows per dispatch.

``--sharded N`` adds the group-sharded deployment arithmetic: G pads up
to a multiple of N, each device hosts padded_G/N groups x all R replica
rows, and the per-device peak is the single-device model at the local
group count.  The mode checks that the per-device blob cost per hosted
group stays at the compact-blob budget (16 + 16*W bytes per group and
replica row, 528 B at W=32) and exits 1 when it does not.

``--paused N`` adds the paused tail's arithmetic: bytes per name in the
packed spill store and index bytes in RAM, from real encodings of a
representative quiescent pause record, checked against a per-name
budget.

The transient model is the reference's: about 30 live [G, W] int32 planes
at the step's worst point, plus the [R, N] gathered compact rows and one
state copy.  It is an envelope of the reference's fused program, not of
the port's kernel, which holds no [G, W] temporaries in device memory: on
the card the stacked bench writes each step's states to fresh tensors, so
its peak is about two state sets, the blob rows and the out vectors
(``testing/bench.py``'s capacity arm reports the card's measured peak
beside this estimate).
"""

from __future__ import annotations

import argparse
import json

from ..obs.gplog import emit

# ~live [G, W] int32 planes at the step's worst point (module docstring)
TRANSIENT_LANE_PLANES = 30
# EngineState: 12 [G] + 7 [G, W] int32 leaves (ops/engine.py:EngineState)
STATE_G_LEAVES = 12
STATE_GW_LEAVES = 7


def legacy_blob_vec_len(G: int, W: int) -> int:
    """Int32 words of the pre-compact all-int32 blob layout (5 ``[G]`` + 7
    ``[G, W]`` planes): the reduction's baseline."""
    return 5 * G + 7 * G * W


def padded_group_count(n_groups: int, n_shards: int) -> int:
    """Smallest shard-divisible G' >= n_groups (ceil to a multiple)."""
    return -(-n_groups // n_shards) * n_shards


def probe(G: int, W: int, K: int, R: int) -> dict:
    from ..ops.engine import EngineConfig, blob_vec_len, out_vec_len

    cfg = EngineConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
    blob_b = 4 * blob_vec_len(cfg)
    legacy_b = 4 * legacy_blob_vec_len(G, W)
    state_b = 4 * (STATE_G_LEAVES * G + STATE_GW_LEAVES * G * W)
    gathered_b = R * blob_b
    transient_b = 4 * TRANSIENT_LANE_PLANES * G * W
    out_b = 4 * out_vec_len(cfg)
    # the single-device bench hosts all R replica states, the shared
    # gathered rows and each replica's transients and out vector
    single_chip_peak_b = R * state_b + gathered_b + R * transient_b + R * out_b
    return {
        "shape": {"G": G, "W": W, "K": K, "R": R},
        "blob_bytes_per_replica": blob_b,
        "blob_bytes_per_group": round(blob_b / G, 1),
        "legacy_blob_bytes_per_replica": legacy_b,
        "blob_reduction_pct": round(100.0 * (1 - blob_b / legacy_b), 1),
        "state_bytes_per_replica": state_b,
        "gathered_rows_bytes": gathered_b,
        "step_transient_estimate_bytes": transient_b,
        "single_chip_peak_estimate_bytes": single_chip_peak_b,
        "single_chip_peak_estimate_gib": round(
            single_chip_peak_b / 2 ** 30, 2
        ),
    }


def device_queue(G: int, W: int, K: int, R: int, n_steps: int) -> dict:
    """Device-resident I/O ring bytes for a deployed node at
    ENGINE_STEPS_PER_DISPATCH=n_steps (the packed_host face): N [G, K]
    request slabs in, N packed out_vec rows back."""
    from ..ops.engine import EngineConfig, out_vec_len

    cfg = EngineConfig(n_groups=G, window=W, req_lanes=K, n_replicas=R)
    req_b = 4 * n_steps * G * K
    out_b = 4 * n_steps * out_vec_len(cfg)
    return {
        "steps_per_dispatch": n_steps,
        "request_ring_bytes": req_b,
        "response_ring_bytes": out_b,
        "total_ring_bytes": req_b + out_b,
        "ring_bytes_per_group": round((req_b + out_b) / G, 1),
    }


def probe_sharded(G: int, W: int, K: int, R: int, n_shards: int) -> dict:
    """Group-sharded deployment arithmetic and the per-group budget check."""
    Gp = padded_group_count(G, n_shards)
    g_loc = Gp // n_shards
    local = probe(g_loc, W, K, R)
    budget_b = 16 + 16 * W  # 4*(4 [G] + 4*W [G, W]) int32 -> 528 at W=32
    per_group = local["blob_bytes_per_replica"] / g_loc
    return {
        "n_shards": n_shards,
        "padded_groups": Gp,
        "groups_per_device": g_loc,
        "pad_overhead_pct": round(100.0 * (Gp - G) / G, 2),
        # each device hosts ALL R replica rows of its shard: the exchange
        # is the locally stacked blobs (no gathered peer rows)
        "per_device_state_bytes": R * local["state_bytes_per_replica"],
        "per_device_blob_bytes": R * local["blob_bytes_per_replica"],
        "per_device_blob_bytes_per_group": round(per_group, 1),
        "compact_budget_bytes_per_group": budget_b,
        "per_device_peak_estimate_bytes":
            local["single_chip_peak_estimate_bytes"],
        "per_device_peak_estimate_gib":
            local["single_chip_peak_estimate_gib"],
        "within_budget": per_group <= budget_b,
    }


def probe_paused(n_paused: int, state_bytes: int, window: int) -> dict:
    """The paused tail's arithmetic: bytes per name in the packed spill
    store on disk and index bytes in RAM, measured from real encodings of
    a representative quiescent pause record, against a per-name budget."""
    import sys as _sys

    from ..utils.packedstore import _HDR, _key_to_wire

    name = "svc0123456"  # representative 10-char service name
    key = (name, 0)
    # quiescent record shape (manager._extract_record): no window
    # remnants, app state of the given size
    rec = {
        "name": name, "epoch": 0, "exec": 64, "bal": 7,
        "app_hash": 2 ** 30, "n_execd": 64,
        "app_state": "x" * max(1, state_bytes),
        "app_exec": 64, "acc": [], "dec": [], "dedup": {},
        "members": [0, 1, 2],
    }
    payload = json.dumps([_key_to_wire(key), rec]).encode("utf-8")
    disk_per_name = _HDR.size + len(payload)
    # RAM tier: the spill index entry (key -> (seg, off, len)) and the
    # by-name epoch mirror (manager._paused_by_name).  Dict slots cost
    # ~3 machine words amortized at CPython's 2/3 fill bound.
    dict_slot = 3 * 8 / (2 / 3)
    index_per_name = (
        _sys.getsizeof(key)
        + _sys.getsizeof(name)
        + _sys.getsizeof((0, 0, 0))
        + 3 * _sys.getsizeof(0)
        + dict_slot  # spill index slot
        + _sys.getsizeof(name) + _sys.getsizeof({0}) + dict_slot  # mirror
    )
    # budget: JSON framing and record scaffolding stay O(100 B) over the
    # app state; the RAM index stays pointer-sized, not record-sized
    disk_budget = 640 + 2 * max(1, state_bytes)
    ram_budget = 1024
    return {
        "n_paused": n_paused,
        "app_state_bytes": state_bytes,
        "window": window,
        "disk_bytes_per_name": disk_per_name,
        "disk_budget_bytes_per_name": disk_budget,
        "index_ram_bytes_per_name": round(index_per_name, 1),
        "index_ram_budget_bytes_per_name": ram_budget,
        "paused_tail_disk_bytes": n_paused * disk_per_name,
        "paused_tail_index_ram_bytes": round(n_paused * index_per_name),
        "within_budget": (
            disk_per_name <= disk_budget and index_per_name <= ram_budget
        ),
    }


def footprint(groups: int = 1_048_576, window: int = 32, req_lanes: int = 16,
              replicas: int = 3, sharded: int = 0, steps_per_dispatch: int = 1,
              paused: int = 0, paused_state_bytes: int = 64) -> dict:
    """The probe's JSON object for one shape (the CLI's flags)."""
    out = probe(groups, window, req_lanes, replicas)
    out["device_queue"] = device_queue(groups, window, req_lanes, replicas,
                                       max(1, steps_per_dispatch))
    if sharded > 0:
        out["sharded"] = probe_sharded(groups, window, req_lanes, replicas, sharded)
    if paused > 0:
        out["paused"] = probe_paused(paused, paused_state_bytes, window)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", "-G", type=int, default=1_048_576)
    ap.add_argument("--window", "-W", type=int, default=32)
    ap.add_argument("--req-lanes", "-K", type=int, default=16)
    ap.add_argument("--replicas", "-R", type=int, default=3)
    ap.add_argument("--sharded", "-N", type=int, default=0, metavar="N",
                    help="add group-sharded arithmetic for an N-device "
                         "mesh and check the per-group blob budget")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    metavar="N",
                    help="device-resident I/O ring bytes at "
                         "ENGINE_STEPS_PER_DISPATCH=N")
    ap.add_argument("--paused", type=int, default=0, metavar="N",
                    help="add paused-tail arithmetic for N paused names "
                         "(packed spill store) and check the per-name "
                         "disk and RAM budgets")
    ap.add_argument("--paused-state-bytes", type=int, default=64,
                    help="representative app-state size inside the "
                         "pause record for --paused")
    args = ap.parse_args(argv)
    out = footprint(args.groups, args.window, args.req_lanes, args.replicas,
                    args.sharded, args.steps_per_dispatch, args.paused,
                    args.paused_state_bytes)
    emit(json.dumps(out))
    if args.sharded > 0 and not out["sharded"]["within_budget"]:
        emit(
            f"FOOTPRINT BUDGET EXCEEDED: "
            f"{out['sharded']['per_device_blob_bytes_per_group']} B/group "
            f"> {out['sharded']['compact_budget_bytes_per_group']} B/group "
            f"compact-blob budget at {args.sharded} shards",
            err=True,
        )
        return 1
    if args.paused > 0 and not out["paused"]["within_budget"]:
        p = out["paused"]
        emit(
            f"PAUSED-TAIL BUDGET EXCEEDED: disk "
            f"{p['disk_bytes_per_name']} B/name (budget "
            f"{p['disk_budget_bytes_per_name']}) / index RAM "
            f"{p['index_ram_bytes_per_name']} B/name (budget "
            f"{p['index_ram_budget_bytes_per_name']})",
            err=True,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
