"""The documented entry points of the port, one counterpart of each file of
the repository's ``examples/`` (the JAX package's):

* :mod:`.simple_env`: a minimal custom environment on a 2-bus grid;
* :mod:`.custom_anm6`: a custom task on the renderable ANM6 grid;
* :mod:`.new_env_template`: the skeleton to copy for a new environment;
* :mod:`.random_agent`: random actions on ANM6Easy, rendered each step;
* :mod:`.mpc_constant`, :mod:`.mpc_perfect`: the host DC-OPF MPC agents;
* :mod:`.mpc_vec`: the batched MPC farm over the planning horizon;
* :mod:`.offline_mixed`: an offline dataset from the capacitor-bank experts;
* :mod:`.gym_vector_interop`: the farm behind Gymnasium's vector wrappers.

Each runs as ``python -m gym_anm_torch.examples.<name> [--cpu]``: on the
CUDA card, or on the CPU with ``--cpu``; without a card and without
``--cpu`` it raises.  Each ``run(...)`` has the JAX example's defaults and
takes ``device=`` (``"cuda"`` by default) and returns what it printed.  The
host examples' ``seed=`` (None: unseeded, as in the JAX examples) seeds the
environment's reset and its action space.
"""
