"""Where the port's entry points run: on the GPU unless the caller asks for
the CPU.  Every entry point that takes a ``device`` defaults to ``None``; with
no CUDA device a call that names none raises and returns no CPU result; with
``device="cpu"`` the results are what the CPU gave before the default changed.

The values recorded below were taken from the package while the CPU was still
its default.  They are held to 1e-4 and not bitwise: torch orders a float32
sum by the vector width of the CPU it runs on, so the last bits of a
log-evidence belong to the machine, and a bitwise pin would hold the test to
one CPU model.  1e-4 is ~25 float32 ulps at 48, far below what a step on
another device or with other defaults would move (the schemes below differ
from one another by 0.02-0.15).  What is bitwise on any machine is held
bitwise: the two spellings of the CPU give the same tensors.
"""

import inspect
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import parallel  # noqa: E402
from advancedps_tpu_torch._device import resolve_device  # noqa: E402

PARAMS = dict(mu=0.0, sigma0=0.5, a=0.9, b=0.0, q=0.32, h=1.0, r=1.0)


def _traced(steps=30):
    model = apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, steps)
    return apt.TracedSSM(model, ys)


def _saved_chain():
    """A chain checkpoint written on the CPU, for the restore entry points."""
    path = os.path.join(tempfile.mkdtemp(), "chain.pt")
    apt.utils.save_chain(path, apt.PGState(torch.zeros(30)), apt.rng.key(1), 1)
    return path


ENTRY_POINTS = {
    "sweep": apt.sweep,
    "sample_smc": apt.sample_smc,
    "step_pg": apt.step_pg,
    "sample_pg": apt.sample_pg,
    "sample": apt.sample,
    "traced_ssm_from_numpy": apt.traced_ssm_from_numpy,
    "multinomial_spacings": apt.multinomial_spacings,
    "sample_chains": parallel.sample_chains,
    "smc_ensemble": parallel.smc_ensemble,
    "particle_mesh": parallel.particle_mesh,
    "chain_particle_mesh": parallel.chain_particle_mesh,
    "resolve_device": resolve_device,
    "model_from_numpy": apt.model_from_numpy,
    "particle_keys": apt.rng.particle_keys,
    "key_tensor": apt.random.key_tensor,
    "bits": apt.random.bits,
    "uniform": apt.random.uniform,
    "normal": apt.random.normal,
    "exponential": apt.random.exponential,
    "bernoulli": apt.random.bernoulli,
    "categorical": apt.random.categorical,
    "gamma": apt.random.gamma,
    "beta": apt.random.beta,
    "t": apt.random.t,
    "poisson": apt.random.poisson,
    "init_distributed": parallel.init_distributed,
    "restore_chain": apt.utils.restore_chain,
    "resume_chain": apt.utils.resume_chain,
}

#: Each entry point called with no ``device``.
CALLS = {
    "sweep": lambda: apt.sweep(apt.rng.key(1), apt.SSMKernel(_traced()), 64,
                               apt.SMC(64).resampler),
    "sample_smc": lambda: apt.sample_smc(apt.rng.key(1), _traced(), apt.SMC(64)),
    "step_pg": lambda: apt.step_pg(apt.rng.key(1), _traced(), apt.PG(16)),
    "sample_pg": lambda: apt.sample_pg(apt.rng.key(1), _traced(), apt.PGAS(16), 2),
    "sample": lambda: apt.sample(apt.rng.key(1), _traced(), apt.SMC(64)),
    "traced_ssm_from_numpy": lambda: apt.traced_ssm_from_numpy(PARAMS, np.zeros(4)),
    "multinomial_spacings": lambda: apt.multinomial_spacings(apt.rng.key(1), 16),
    "sample_chains": lambda: parallel.sample_chains(apt.rng.key(1), _traced(), apt.PG(16), 2, 2),
    "smc_ensemble": lambda: parallel.smc_ensemble(apt.rng.key(1), _traced(), apt.SMC(64), 2),
    "particle_mesh": lambda: parallel.particle_mesh(4),
    "chain_particle_mesh": lambda: parallel.chain_particle_mesh(2, 2),
    "resolve_device": lambda: resolve_device(),
    "model_from_numpy": lambda: apt.model_from_numpy("stochastic_volatility", {"a": 0.9, "q": 0.5}),
    "particle_keys": lambda: apt.rng.particle_keys(apt.rng.key(1), apt.rng.PROPAGATE, 1, 8),
    # A host Key names no device: the draws are made on the GPU.
    "key_tensor": lambda: apt.random.key_tensor(apt.rng.key(1)),
    "bits": lambda: apt.random.bits(apt.rng.key(1), (4,)),
    "uniform": lambda: apt.random.uniform(apt.rng.key(1), (4,)),
    "normal": lambda: apt.random.normal(apt.rng.key(1), (4,)),
    "exponential": lambda: apt.random.exponential(apt.rng.key(1), (4,)),
    "bernoulli": lambda: apt.random.bernoulli(apt.rng.key(1), 0.5, (4,)),
    "categorical": lambda: apt.random.categorical(apt.rng.key(1), [0.0, 1.0]),
    "gamma": lambda: apt.random.gamma(apt.rng.key(1), 2.0, (4,)),
    "beta": lambda: apt.random.beta(apt.rng.key(1), 2.0, 3.0, (4,)),
    "t": lambda: apt.random.t(apt.rng.key(1), 3.0, (4,)),
    "poisson": lambda: apt.random.poisson(apt.rng.key(1), 3.0, (4,)),
    # NCCL on the card: refused before any process group is started.
    "init_distributed": lambda: parallel.init_distributed("localhost:1", 1, 0),
    "restore_chain": lambda: apt.utils.restore_chain(_saved_chain()),
    "resume_chain": lambda: apt.utils.resume_chain(_saved_chain(), _traced(), apt.PG(16), 1),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_defaults_to_none(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default is None


def test_every_device_parameter_of_the_package_is_listed():
    # Any public function of the package that takes a `device` is an entry
    # point in the sense above and must be in the table.
    found = set()
    modules = [apt, apt.engine, apt.inference, apt.convert, apt.resampling, apt.rng, apt.smc,
               apt.pg, apt.ssm, apt.random, apt.distributions, apt.models, apt.generic,
               apt.utils, apt.utils.checkpoint, parallel, parallel.mesh, parallel.chains,
               parallel.sharded, parallel.smc, parallel.pg]
    for mod in modules:
        for attr, fn in vars(mod).items():
            if inspect.isfunction(fn) and not attr.startswith("_") \
                    and "device" in inspect.signature(fn).parameters:
                found.add(fn)
    assert found <= set(ENTRY_POINTS.values())


@pytest.mark.parametrize("name", sorted(CALLS))
def test_no_device_and_no_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CALLS[name]()


def test_resolve_device_passes_an_explicit_device_through():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    assert resolve_device("cuda:1") == torch.device("cuda", 1)  # named, not probed


#: log-evidence of SMC(512) over _traced() with key 1 on the CPU, per scheme,
#: as the package gave it when the CPU was the default.
CPU_LOG_EVIDENCE = {
    "resample_systematic": -48.12458038330078,
    "resample_stratified": -48.10308074951172,
    "resample_multinomial": -48.02927780151367,
    "resample_residual": -47.98008728027344,
}


@pytest.mark.parametrize("scheme", sorted(CPU_LOG_EVIDENCE))
def test_cpu_results_are_what_they_were(scheme):
    sampler = apt.SMC(512, apt.ResampleWithESSThreshold(getattr(apt, scheme)))
    by_name = apt.sample(apt.rng.key(1), _traced(), sampler, device="cpu")
    by_object = apt.sample(apt.rng.key(1), _traced(), sampler, device=torch.device("cpu"))
    assert abs(float(by_name.log_evidence) - CPU_LOG_EVIDENCE[scheme]) < 1e-4
    assert torch.equal(by_name.log_evidence, by_object.log_evidence)
    assert torch.equal(by_name.trajectories, by_object.trajectories)
    assert by_name.trajectories.device.type == "cpu"


def test_cpu_pgas_chain_is_what_it_was():
    chain = apt.sample(apt.rng.key(2), _traced(), apt.PGAS(64), 4,
                       trajectory_storage="replay", device="cpu")
    want = [-47.56237030029297, -48.32826232910156, -47.76005172729492, -48.21641159057617]
    np.testing.assert_allclose(chain.log_evidence.numpy(), want, atol=1e-4, rtol=0)
    assert chain.trajectory.shape == (4, 30) and chain.trajectory.device.type == "cpu"


def test_meshes_hold_the_named_device():
    assert parallel.particle_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    rows = parallel.chain_particle_mesh(2, 2, "cpu").rows
    assert [r.devices for r in rows] == [(torch.device("cpu"),) * 2] * 2
    spacings = apt.multinomial_spacings(apt.rng.key(3), 100, device="cpu")
    assert spacings.shape == (101,) and spacings.device.type == "cpu"


@pytest.mark.cuda
def test_a_law_from_the_card_reads_its_values_on_the_cpu():
    # A copy from the card to the CPU must have landed before the CPU reads
    # it, both in ``Distribution.to`` and in a CPU sweep over a program whose
    # parameters lie on the card.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    loc = torch.linspace(-3.0, 3.0, 1 << 20, device="cuda")
    scale = torch.full((1 << 20,), 2.5, device="cuda")
    law = apt.Normal(loc, scale).to("cpu")
    assert law.loc.device.type == "cpu"
    assert torch.equal(law.loc, loc.cpu()) and torch.equal(law.scale, scale.cpu())

    def program(where):
        mean, sd = torch.zeros(3, device=where), torch.ones(3, device=where)

        def fn(ctx):
            v = ctx.sample(apt.Normal(mean, sd), name="v")
            ctx.observe(apt.Normal(v.sum(), 1.0), 0.5)
        return apt.GenericModel(fn)

    on_card = apt.sample(apt.rng.key(4), program("cuda"), apt.SMC(64), device="cpu")
    on_cpu = apt.sample(apt.rng.key(4), program("cpu"), apt.SMC(64), device="cpu")
    assert torch.equal(on_card.log_evidence, on_cpu.log_evidence)
    assert torch.equal(on_card.trajectories, on_cpu.trajectories)
