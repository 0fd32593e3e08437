"""l2hmc — an L2HMC framework in JAX / XLA, run on NVIDIA GPUs.

A from-scratch rebuild of the capability set of saforem2/l2hmc:

- pure-functional transition kernels under `jax.jit` (`lax.scan` hot loops),
- chains vectorized on the batch axis and sharded over a `jax.sharding.Mesh`,
- a whole-chain CUDA kernel for plain U(1) HMC (`ops/u1_chain.cu`),
- explicit PRNG key threading (no hidden RNG state),
- single-pytree checkpointing (numpy .npz + JSON config sidecar).

Subpackages
-----------
lattice   U(1) gauge lattice (Wilson action, observables), Ising, SU(N) scaffolding
targets   analytic target distributions (Gaussian/GMM/rough-well/funnel/...)
networks  scale/translation/transformation nets (MLP + periodic CNN)
dynamics  L2HMC augmented leapfrog, plain HMC, NUTS, AIS, SMC
ops       Wilson action + analytic VJP, whole-chain HMC kernel, group math
train     losses, schedules, trainer, checkpointing
parallel  mesh/sharding utilities, multi-host data parallelism, halo exchange
analysis  autocorrelation/ESS/IAT, jackknife, tunneling diagnostics
utils     config, IO, logging
"""

__version__ = "0.1.0"
