"""The port's process-spanning mesh: two spawned gloo CPU ranks.

Mirrors ``tests/test_multiprocess.py`` with the port's own layer
(``parallel.init_distributed`` over ``torch.distributed``): two real
processes, two shards each, join one 4-shard mesh and run the conditional
sharded sweep with PGAS ancestor sampling (T = 10, N = 512, the JAX test's
sizes).  Both ranks must print the same logZ, ESS, gate flags, ancestors
and final log-weights, bit for bit; those must be bitwise the sweep of the
one-process 4-shard mesh run here; and logZ must lie within 0.05 of the
single-device sweep, and agree with the JAX package's sharded sweep on the
same key words as the 8-shard comparison of ``test_torch_sharded.py`` does
(ancestors > 0.99, logZ within 0.2).  One case forces the all-gather
exchange, one takes ``auto`` (the neighbour exchange, whose ring shifts cross the rank boundary
point to point, where its predicate holds).

The worker is this file's own ``__main__`` block:

    python tests/test_torch_multiprocess.py <rank> <world> <port> <exchange>
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NPROC = 2
T, N, K = 10, 512, 4
CHILD_TIMEOUT_S = 120


def _inputs():
    import advancedps_tpu_torch as apt

    model = apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0).to("cpu")
    _, ys = apt.simulate(apt.rng.key(0), model, T)
    kernel = apt.SSMKernel(apt.TracedSSM(model, ys))
    return apt, kernel, apt.PGAS(N).resampler, torch.linspace(-0.5, 0.5, T), apt.rng.key(3)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def _summary(res, mesh) -> dict:
    return {
        "log_z": float(res.log_evidence).hex(),
        "ess": [float(e).hex() for e in res.ess],
        "resampled": [bool(b) for b in res.resampled],
        "ancestors": _digest(res.ancestors),
        "log_weights": _digest(res.log_weights),
        "shape": list(res.ancestors.shape),
        "exchanges": dict(mesh.exchanges),
    }


def _sharded(mesh, exchange):
    from advancedps_tpu_torch import parallel

    apt, kernel, resampler, ref, key = _inputs()
    return parallel.sharded_sweep(key, kernel, N, resampler, mesh, ref=ref,
                                  ancestor_sampling=True, store_states=False, exchange=exchange)


def _worker(rank: int, world: int, port: str, exchange: str):
    import torch.distributed as dist

    from advancedps_tpu_torch import parallel

    parallel.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = parallel.particle_mesh(K, "cpu")
        res = _sharded(mesh, exchange)
        out = {"rank": rank, "world": dist.get_world_size(), "local": list(mesh.local),
               "ppermute": mesh.calls["ppermute"], **_summary(res, mesh)}
        print("RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


# --- the test (the parent) ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(rank, port, exchange):
    env = dict(os.environ, PYTHONPATH=_REPO, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(_NPROC), str(port), exchange],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _run_ranks(exchange):
    port = _free_port()
    procs = [_spawn(r, port, exchange) for r in range(_NPROC)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish in {CHILD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rc, out, err in outs:
        assert rc == 0, f"rank failed rc={rc}:\n{(out + err)[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def _check(exchange):
    from advancedps_tpu_torch import parallel

    a, b = _run_ranks(exchange)
    assert (a["world"], b["world"]) == (2, 2)
    assert (a["local"], b["local"]) == ([0, 1], [2, 3])
    keys = ("log_z", "ess", "resampled", "ancestors", "log_weights", "shape", "exchanges")
    # Every rank returns the whole, replicated result: identical bits.
    for k in keys:
        assert a[k] == b[k], k
    assert a["shape"] == [T, N]
    # ... bitwise the one-process 4-shard mesh's sweep.
    mesh = parallel.particle_mesh(K, "cpu")
    one_res = _sharded(mesh, exchange)
    one = _summary(one_res, mesh)
    for k in keys:
        assert a[k] == one[k], k
    # ... and within Monte Carlo reach of the single-device sweep.
    apt, kernel, resampler, ref, key = _inputs()
    single = apt.sweep(key, kernel, N, resampler, ref=ref, ancestor_sampling=True,
                       store_states=False, device="cpu")
    assert abs(float.fromhex(a["log_z"]) - float(single.log_evidence)) < 0.05
    # ... and, as a direct witness, the JAX package's sharded sweep on the same
    # key words and inputs over 4 virtual devices: the contract of
    # test_torch_sharded.py (ancestors agree > 0.99, logZ within 0.2).
    import jax
    import jax.numpy as jnp
    import numpy as np

    import advancedps_tpu as aps
    from advancedps_tpu.parallel import particle_mesh as jparticle_mesh
    from advancedps_tpu.parallel import sharded_sweep as jsharded_sweep

    jkernel = aps.SSMKernel(ssm=aps.TracedSSM(aps.models.stationary_lgssm(0.9, 0.32, 1.0),
                                              jnp.asarray(kernel.ssm.observations.numpy())))
    jkey = jax.random.wrap_key_data(jnp.asarray([key.k0, key.k1], dtype=jnp.uint32))
    jres = jsharded_sweep(jkey, jkernel, N, aps.PGAS(N).resampler, jparticle_mesh(K),
                          ref=jnp.asarray(ref.numpy()), ancestor_sampling=True,
                          store_states=False, exchange=exchange)
    agree = (np.asarray(jres.ancestors) == one_res.ancestors.numpy()).mean()
    assert agree > 0.99, agree
    assert abs(float.fromhex(a["log_z"]) - float(jres.log_evidence)) < 0.2
    return a


def test_two_process_mesh_allgather_is_bitwise_the_one_process_mesh():
    a = _check("allgather")
    assert a["exchanges"] == {"allgather": T - 1}


def test_two_process_mesh_auto_is_bitwise_the_one_process_mesh():
    a = _check("auto")
    # The neighbour exchange ran, its ring shifts crossing the ranks.
    assert a["exchanges"].get("neighbor", 0) > 0 and a["ppermute"] > 0
    assert sum(a["exchanges"].values()) == T - 1


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
