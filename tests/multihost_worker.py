"""Worker process for the real multi-process distributed test.

Launched by ``tests/test_multihost.py`` (2 processes x 4 virtual CPU
devices = 8 global devices). Exercises the config-5 path from
BASELINE.md: a global ``(stations, time)`` mesh spanning PROCESS
boundaries, the fused channelize+WBFM step jitted over it, and the
ppermute halo-exchange FIR whose neighbors live in the other process —
i.e. collectives that actually cross the distributed runtime, not just
an intra-process virtual mesh.

The reference has no multi-process runtime at all (its inter-process
transport is ZeroMQ PUB/SUB, reference ``examples/multi_fm_server.py:
116-120``); this is the sharded replacement (SURVEY.md §2.5).

argv: <process_id> <num_processes> <coordinator_address> <local_devices>
      [n_stations station_chunk audio_chunk timed_iters]
Prints one line ``CHECKSUM <mean-abs-audio> HALO <mean-abs-fir>``
(plus `` SPS <global-samples/s> CHIPS <n>`` when timed_iters > 0) on
success; asserts otherwise. The optional tail arguments run the config-5
rehearsal shape (e.g. 128 stations) instead of the default tiny world.
"""

import os
import sys
import time


def main() -> None:
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    coord = sys.argv[3]
    local = int(sys.argv[4])
    arg_stations = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    arg_chunk = int(sys.argv[6]) if len(sys.argv) > 6 else 0
    arg_audio = int(sys.argv[7]) if len(sys.argv) > 7 else 0
    timed_iters = int(sys.argv[8]) if len(sys.argv) > 8 else 0

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={local}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from radiocore_tpu.runtime.platform import (initialize_multihost,
                                                platform_summary)

    initialize_multihost(coordinator_address=coord,
                         num_processes=nprocs, process_id=pid)

    summary = platform_summary()
    assert summary["process_count"] == nprocs, summary
    assert jax.device_count() == nprocs * local, jax.device_count()
    assert jax.local_device_count() == local

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radiocore_tpu.parallel.mesh import make_radio_mesh, TIME
    from radiocore_tpu.parallel.pipeline import make_multi_station_step
    from radiocore_tpu.parallel.halo import zero_phase_fir_sharded

    # Global mesh: time axis = nprocs so ppermute neighbors straddle the
    # process boundary; stations axis takes the rest.
    mesh = make_radio_mesh(time=nprocs)
    # The station COUNT is independent of the mesh: the fused pipeline
    # shards stations over every device (config-5 rehearsal runs ≥100
    # stations on this 8-device world).
    n_stations = arg_stations or mesh.shape["stations"]

    station_chunk = arg_chunk or 50_000
    audio_chunk = arg_audio or 10_000
    n_band = n_stations * station_chunk
    half = n_band // 2 - station_chunk // 2
    offsets = [int(-half + i * station_chunk) for i in range(n_stations)]

    step, state = make_multi_station_step(
        n_band, offsets, station_chunk, audio_chunk, mesh=mesh)

    @jax.jit
    def _band(key):
        planes = 0.1 * jax.random.normal(key, (2, n_band), jnp.float32)
        return jax.lax.complex(planes[0], planes[1])

    make_band = jax.jit(_band, out_shardings=NamedSharding(mesh, P(TIME)))
    band = make_band(jax.random.key(7))

    audio, state = step(band, state)
    # Second chunk: streaming state (deemphasis tails) crosses steps while
    # sharded across processes.
    audio, state = step(band, state)

    checksum = jax.jit(lambda a: jnp.mean(jnp.abs(a)),
                       out_shardings=NamedSharding(mesh, P()))(audio)
    checksum = float(checksum)  # fully replicated -> addressable everywhere

    # Halo-exchange zero-phase FIR over the cross-process time axis.
    from scipy import signal as sig
    taps = np.asarray(sig.firwin(33, 0.25), np.float32)
    n = nprocs * local * 4096
    x = jax.jit(
        lambda: jnp.sin(jnp.arange(n, dtype=jnp.float32) * 0.01),
        out_shardings=NamedSharding(mesh, P(TIME)))()
    y = zero_phase_fir_sharded(x, taps, mesh)
    halo_sum = jax.jit(lambda a: jnp.mean(jnp.abs(a)),
                       out_shardings=NamedSharding(mesh, P()))(y)
    halo_sum = float(halo_sum)

    line = f"CHECKSUM {checksum:.10e} HALO {halo_sum:.10e}"

    if timed_iters > 0:
        # Per-device throughput at the rehearsal scale; the
        # audio-derived scalar serializes the steps.
        chk = jnp.float32(0)
        jitter = jax.jit(lambda b, c: b * (1.0 + c * 1e-3))
        chk_fn = jax.jit(lambda a: jnp.mean(jnp.abs(a)),
                         out_shardings=NamedSharding(mesh, P()))
        float(checksum)
        t0 = time.perf_counter()
        for _ in range(timed_iters):
            audio, state = step(jitter(band, chk), state)
            chk = chk_fn(audio)
        float(chk)
        dt = (time.perf_counter() - t0) / timed_iters
        sps = n_stations * station_chunk / dt
        line += f" SPS {sps:.6e} CHIPS {jax.device_count()}"

        # Per-process collective bytes of the distributed front-end (the
        # only cross-process stage) — static, from this process's own
        # compiled HLO, next to the checksum parity.
        try:
            from radiocore_tpu.parallel.pipeline import (
                _make_distributed_fused)
            from radiocore_tpu.parallel.comm_analysis import (
                collective_bytes)
            dist = _make_distributed_fused(mesh, n_band, offsets,
                                           station_chunk)
            if dist is not None:
                txt = dist.lower(
                    jax.ShapeDtypeStruct((n_band,), jnp.complex64)
                ).compile().as_text()
                line += f" COLLBYTES {collective_bytes(txt).get('total', 0)}"
        except Exception:
            pass

    print(line, flush=True)


if __name__ == "__main__":
    main()
