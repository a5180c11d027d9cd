"""The skeleton to copy when designing a new gym-anm-torch environment.

Port of ``examples/new_env_template.py``: subclass
:class:`~gym_anm_torch.compat.ANMEnv`, provide the network dictionary and
MDP constants, and implement the two stochastic hooks ``init_state`` /
``next_vars`` (plus the optional overrides listed below).  The float64
transition runs on ``device`` (the card by default, ``"cpu"`` on request).
See ``docs/design_new_env.md`` for the column layout of the network tables.
It is a skeleton: it has no ``run``, and instantiating it is meaningless.
"""

from ..compat import ANMEnv


class CustomEnvironment(ANMEnv):
    def __init__(self, device="cuda"):
        network = {"baseMVA": ..., "bus": ..., "device": ..., "branch": ...}
        observation = ...       # "state", a list of (var, ids, unit), or a callable
        K = ...                 # number of auxiliary variables
        delta_t = ...           # timestep duration (hours)
        gamma = ...             # discount factor
        lamb = ...              # penalty weighting hyperparameter
        aux_bounds = ...        # bounds on auxiliary variables (optional)
        costs_clipping = ...    # (e_loss clip, penalty clip) (optional)
        seed = ...              # random seed (optional)

        super().__init__(network, observation, K, delta_t, gamma, lamb,
                         aux_bounds, costs_clipping, seed, device=device)

    def init_state(self):
        """Return the initial state vector s0 (numpy, length
        2·N_device + N_des + N_non_slack_gen + K)."""
        ...

    def next_vars(self, s_t):
        """Return [P_load..., P_potential..., aux...] for the next step."""
        ...

    def observation_bounds(self):  # optional — only for callable observations
        ...

    def render(self, mode="human"):  # optional
        ...

    def close(self):  # optional
        ...
