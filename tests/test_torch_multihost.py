"""Multi-host serving of the port on the CPU: real torch.distributed
processes (gloo over tcp://127.0.0.1), each one "host" of virtual CPU
slots, as tests/test_multihost.py runs jax.distributed processes.

Run as a script this file is the worker of one host:

    python tests/test_torch_multihost.py <rank> <port> <n_procs> <n_slots> <out_dir>

It joins the process group, builds the (hosts, dp) mesh with
make_multihost_mesh, feeds only its own rows of a 16-stream batch
(host-local ingest) through make_sharded_pipeline_step with every
collective patched to raise, checks that its outputs hold exactly its rows
of the global batch, gathers one float over gloo (the bench line's kind of
reduction), and writes its rows to <out_dir>/rank<i>.npz. The test holds
those rows against the same rows computed in one process by the unsharded
pipeline_step: equal, since every row is computed alone and each slot holds
two rows (see tests/test_torch_parallel.py on one-row slots).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 16
HOP = 256


def _params():
    from pitchvis_tpu_torch.core.config import VqtParameters, VqtRange

    return VqtParameters(n_fft=2048, range=VqtRange(min_freq=220.0, octaves=3, buckets_per_octave=12))


def _global_chunk():
    return (np.random.default_rng(100).standard_normal((GLOBAL_BATCH, HOP)) * 0.05).astype(np.float32)


def worker(rank: int, port: str, n_procs: int, n_slots: int, out_dir: str) -> None:
    import torch.distributed as dist

    from pitchvis_tpu_torch import get_kernel, init_pipeline_state, make_vqt_arrays
    from pitchvis_tpu_torch.parallel.sharding import (
        make_multihost_mesh,
        make_sharded_pipeline_step,
        multihost_stream_sharding,
        no_collectives,
        replicate,
    )

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n_procs, rank=rank)
    try:
        mesh = make_multihost_mesh(n_devices=n_slots, device="cpu")
        assert mesh.devices.shape == (n_procs, n_slots), mesh.devices.shape
        assert mesh.axis_names == ("hosts", "dp") and mesh.process_index == rank
        params = _params()
        local = GLOBAL_BATCH // n_procs
        mine = slice(rank * local, (rank + 1) * local)
        rows = multihost_stream_sharding(mesh)
        arrays = replicate(mesh, make_vqt_arrays(get_kernel(params), path="pallas", device="cpu"))
        # host-local ingest: each host supplies only its own rows
        state = rows.put_local(init_pipeline_state(local, params, device="cpu"))
        chunk = rows.put_local(_global_chunk()[mine])
        step = make_sharded_pipeline_step(mesh, vqt_params=params, path="pallas")
        with no_collectives():
            state, out = step(arrays, state, chunk, 1.0 / 60.0)
        x_vqt = out.x_vqt
        assert x_vqt.shape == (GLOBAL_BATCH, params.n_buckets) and len(x_vqt.shards) == n_slots
        assert sum(x_vqt.piece_rows()) == local and not x_vqt.fully_addressable
        pieces = [torch.cat(list(leaf.shards)).numpy() for leaf in (out.x_vqt, out.analysis.peaks, out.gain)]
        rate = torch.tensor([float(rank + 1)], dtype=torch.float64)
        gathered = [torch.zeros(1, dtype=torch.float64) for _ in range(n_procs)]
        dist.all_gather(gathered, rate)
        assert [g.item() for g in gathered] == [float(i + 1) for i in range(n_procs)]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), x_vqt=pieces[0], peaks=pieces[1], gain=pieces[2])
        print(f"[{rank}] MULTIHOST_OK", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    return env


import pytest  # noqa: E402


@pytest.mark.parametrize("n_procs,n_slots", [(2, 4), (4, 2)], ids=["2hosts_x4", "4hosts_x2"])
def test_multi_host_serving_step(tmp_path, n_procs, n_slots):
    """Each host serves its own rows over its slots; together they equal
    the unsharded step of the whole batch, row for row."""
    from pitchvis_tpu_torch import get_kernel, init_pipeline_state, make_vqt_arrays, pipeline_step

    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), str(port), str(n_procs), str(n_slots),
                          str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
        for i in range(n_procs)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"[{i}] MULTIHOST_OK" in out

    params = _params()
    _, want = pipeline_step(make_vqt_arrays(get_kernel(params), path="pallas", device="cpu"),
                            init_pipeline_state(GLOBAL_BATCH, params, device="cpu"), torch.from_numpy(_global_chunk()),
                            1.0 / 60.0, vqt_params=params, path="pallas")
    local = GLOBAL_BATCH // n_procs
    for i in range(n_procs):
        with np.load(tmp_path / f"rank{i}.npz") as z:
            rows = slice(i * local, (i + 1) * local)
            np.testing.assert_array_equal(z["x_vqt"], want.x_vqt[rows].numpy())
            np.testing.assert_array_equal(z["peaks"], want.analysis.peaks[rows].numpy())
            np.testing.assert_array_equal(z["gain"], want.gain[rows].numpy())


def test_deployment_recipe_script():
    """The recipe (runtime/multihost_serve.py: a native ring bank and
    producer a host, the hop over the host's slots, the start-up check for
    collectives, the gathered bench line) runs as two processes on the CPU
    and prints the cluster's JSON line."""
    proc = subprocess.run(
        [sys.executable, "-m", "pitchvis_tpu_torch.runtime.multihost_serve", "--spawn", "2", "--device", "cpu",
         "--devices-per-host", "2", "--streams-per-host", "8", "--seconds", "1.5", "--small", "--path", "pallas"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    result = json.loads(line)
    assert result["metric"] == "multihost_streams_realtime_factor"
    assert result["hosts"] == 2 and result["streams"] == 16
    assert result["steps_per_host"] > 0 and result["value"] > 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
