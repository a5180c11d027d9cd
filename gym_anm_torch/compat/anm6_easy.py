"""The ANM6 environment family and the ANM6Easy-v0 task.

Port of ``gym_anm_tpu/compat/anm6_easy.py``, the drop-in equivalent of
``gym_anm/envs/anm6_env/anm6.py:13-239`` and ``anm6_easy.py:8-132``: a
6-bus, 7-device renderable network and the canonical deterministic task
with fixed 24-hour (96-step) load/generation profiles, a time-of-day
auxiliary variable, Δt=15min, γ=0.995, λ=100 and cost clipping (1, 100).

The daily profiles are :func:`gym_anm_torch.networks.anm6.anm6easy_load_time_series`
and its generator counterpart, the tables the batched task reads too.  The
browser renderer of the JAX package (``gym_anm_tpu.render``) is not ported
yet: :meth:`ANM6.render` raises ``NotImplementedError`` until it is.
"""

import datetime as dt
from typing import Optional

import numpy as np

from ..networks.anm6 import anm6easy_gen_time_series, anm6easy_load_time_series, network
from .anm_env import ANMEnv

# The names of the JAX package's compat module for the fixed profiles.
_get_load_time_series = anm6easy_load_time_series
_get_gen_time_series = anm6easy_gen_time_series

_NO_RENDERER = ("ANM6 rendering needs the web renderer (the JAX package's gym_anm_tpu.render), "
                "which gym_anm_torch does not carry yet")


def random_date(np_random, year):
    """A datetime of 00:00 on a random day of ``year``
    (anm6_env/utils.py:5-23)."""
    return dt.datetime(year, 1, 1) + dt.timedelta(days=float(np_random.integers(1, 365)))


class ANM6(ANMEnv):
    """Base class for 6-bus environments with web rendering support."""

    metadata = {"render_modes": ["human"]}

    def __init__(self, observation, K, delta_t, gamma, lamb, aux_bounds=None,
                 costs_clipping=(None, None), seed=None, device="cuda"):
        super().__init__(network, observation, K, delta_t, gamma, lamb,
                         aux_bounds, costs_clipping, seed, device=device)

        self.network_specs = self.simulator.get_rendering_specs()
        self.timestep_length = dt.timedelta(minutes=int(60 * delta_t))
        self.date = None
        self.date_init = None
        self.year_count = 0
        self.skipped_frames = None
        self.render_mode = None
        self.is_rendering = False

    def step(self, action):
        obs, r, terminated, truncated, info = super().step(action)
        self.date += self.timestep_length
        self.year_count = (self.date - self.date_init).days // 365
        return obs, r, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        render_mode = self.render_mode
        obs, info = super().reset(seed=seed, options=options)
        self.render_mode = render_mode

        self.year_count = 0
        if options is not None and "date_init" in options:
            self.date_init = options["date_init"]
        else:
            self.date_init = random_date(self.np_random, 2020)
        self.date = self.date_init
        return obs, info

    def reset_date(self, date_init):
        """Reset the rendered date and year count."""
        self.date_init = date_init
        self.date = date_init

    # --- rendering (anm6.py:46-111) --------------------------------------
    def render(self, mode="human", skip_frames=0):
        if (self.render_mode or mode) not in ["human"]:
            raise NotImplementedError()
        self._init_render(self.network_specs)

    def _init_render(self, network_specs):
        raise NotImplementedError(_NO_RENDERER)

    def _update_render(self, dev_p, dev_q, branch_s, des_soc, gen_p_max,
                       bus_v_magn, costs, network_collapsed):
        raise NotImplementedError(_NO_RENDERER)

    def close(self):
        self.render_mode = None
        self.is_rendering = False


class ANM6Easy(ANM6):
    """The ANM6Easy-v0 task (anm6_easy.py:8-74)."""

    def __init__(self, device="cuda"):
        observation = "state"
        K = 1
        delta_t = 0.25
        gamma = 0.995
        lamb = 100
        aux_bounds = np.array([[0, 24 / delta_t - 1]])
        costs_clipping = (1, 100)
        super().__init__(observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping,
                         device=device)

        self.P_loads = anm6easy_load_time_series()
        self.P_maxs = anm6easy_gen_time_series()

    def init_state(self):
        n_dev, n_gen, n_des = 7, 2, 1
        state = np.zeros(2 * n_dev + n_des + n_gen + self.K)

        t_0 = self.np_random.integers(0, int(24 / self.delta_t))
        state[-1] = t_0

        # Load (P, Q) injections.
        for dev_id, p_load in zip([1, 3, 5], self.P_loads):
            state[dev_id] = p_load[t_0]
            state[n_dev + dev_id] = p_load[t_0] * self.simulator.devices[dev_id].qp_ratio

        # Non-slack generator (P, Q) injections.
        for idx, (dev_id, p_max) in enumerate(zip([2, 4], self.P_maxs)):
            state[2 * n_dev + n_des + idx] = p_max[t_0]
            state[dev_id] = p_max[t_0]
            state[n_dev + dev_id] = self.np_random.uniform(
                self.simulator.devices[dev_id].q_min, self.simulator.devices[dev_id].q_max
            )

        # Energy storage unit.
        for idx, dev_id in enumerate([6]):
            state[2 * n_dev + idx] = self.np_random.uniform(
                self.simulator.devices[dev_id].soc_min, self.simulator.devices[dev_id].soc_max
            )

        return state

    def next_vars(self, s_t):
        aux = int((s_t[-1] + 1) % (24 / self.delta_t))
        vars = []
        for p_load in self.P_loads:
            vars.append(p_load[aux])
        for p_max in self.P_maxs:
            vars.append(p_max[aux])
        vars.append(aux)
        return np.array(vars)

    def reset(self, **kwargs):
        obs, info = super().reset(**kwargs)
        # Reset the time of day from the auxiliary variable.
        new_date = self.date + self.state[-1] * self.timestep_length
        super().reset_date(new_date)
        return obs, info
