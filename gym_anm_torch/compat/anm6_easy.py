"""The ANM6 environment family and the ANM6Easy-v0 task.

Port of ``gym_anm_tpu/compat/anm6_easy.py``, the drop-in equivalent of
``gym_anm/envs/anm6_env/anm6.py:13-239`` and ``anm6_easy.py:8-132``: a
6-bus, 7-device renderable network and the canonical deterministic task
with fixed 24-hour (96-step) load/generation profiles, a time-of-day
auxiliary variable, Δt=15min, γ=0.995, λ=100 and cost clipping (1, 100).

The daily profiles are :func:`gym_anm_torch.networks.anm6.anm6easy_load_time_series`
and its generator counterpart, the tables the batched task reads too.  The
browser rendering hooks are provided by :mod:`gym_anm_torch.render` (HTTP +
WebSocket servers); rendering is lazy and entirely optional.  A frame reads
the host views the transition has already copied out, so ``render()``
launches no work on the card and waits for none.
"""

import datetime as dt
from typing import Optional

import numpy as np

from ..networks.anm6 import anm6easy_gen_time_series, anm6easy_load_time_series, network
from .anm_env import ANMEnv

# The names of the JAX package's compat module for the fixed profiles.
_get_load_time_series = anm6easy_load_time_series
_get_gen_time_series = anm6easy_gen_time_series


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

    # --- rendering (lazy import; anm6.py:46-111) -----------------------
    def render(self, mode="human", skip_frames=0):
        # Init keys on is_rendering, NOT `render_mode is None`: Gymnasium
        # users routinely set env.render_mode = "human" themselves, which
        # must not skip server startup (it left skipped_frames=None and
        # crashed the frame branch).
        if not self.is_rendering:
            if (self.render_mode or mode) not in ["human"]:
                raise NotImplementedError()
            self.render_mode = self.render_mode or mode
            self.skipped_frames = 0
            rendered = ["dev_type", "dev_p", "dev_q", "branch_s", "bus_v", "des_soc"]
            specs = {s: self.network_specs[s] for s in rendered}
            self._init_render(specs)
            self.is_rendering = True
            self.render(mode=self.render_mode, skip_frames=skip_frames)
        else:
            self.skipped_frames = (self.skipped_frames + 1) % (skip_frames + 1)
            if self.skipped_frames:
                return
            fs = self.simulator.state
            self._update_render(
                list(fs["dev_p"]["MW"].values()),
                list(fs["dev_q"]["MVAr"].values()),
                list(fs["branch_s"]["MVA"].values()),
                list(fs["des_soc"]["MWh"].values()),
                list(fs["gen_p_max"]["MW"].values()),
                list(fs["bus_v_magn"]["pu"].values()),
                [self.e_loss, self.penalty],
                not self.simulator.pfe_converged,
            )

    def _init_render(self, network_specs):
        from ..render import rendering

        title = type(self).__name__
        dev_type = list(network_specs["dev_type"].values())
        ps, qs = [], []
        for i in network_specs["dev_p"].keys():
            ps.append(np.max(np.abs([network_specs["dev_p"][i]["MW"][j] for j in [0, 1]])))
            qs.append(np.max(np.abs([network_specs["dev_q"][i]["MVAr"][j] for j in [0, 1]])))
        branch_rate = [network_specs["branch_s"][br]["MVA"][1] for br in network_specs["branch_s"]]
        bus_v_min = [network_specs["bus_v"][i]["pu"][0] for i in network_specs["bus_v"]]
        bus_v_max = [network_specs["bus_v"][i]["pu"][1] for i in network_specs["bus_v"]]
        soc_max = [network_specs["des_soc"][i]["MWh"][1] for i in network_specs["des_soc"]]
        c1 = 100 if self.costs_clipping[0] is None else self.costs_clipping[0]
        c2 = 10000 if self.costs_clipping[1] is None else self.costs_clipping[1]
        sim = self.simulator
        topology = {
            "busIds": list(sim.buses.keys()),
            "devBus": [dev.bus_id for dev in sim.devices.values()],
            "branchFrom": [f for f, _ in sim.branches.keys()],
            "branchTo": [t for _, t in sim.branches.keys()],
            # The hand-tuned ANM6 diagram arrangement (reference artwork
            # equivalent, render/rendering.py:ANM6_LAYOUT).
            "busXY": rendering.ANM6_LAYOUT,
        }
        self.http_server, self.ws_server = rendering.start(
            title, dev_type, ps, qs, branch_rate, bus_v_min, bus_v_max, soc_max,
            (c1, c2), topology=topology,
        )

    def _update_render(self, dev_p, dev_q, branch_s, des_soc, gen_p_max,
                       bus_v_magn, costs, network_collapsed):
        from ..render import rendering

        rendering.update(
            self.ws_server, self.date, self.year_count, dev_p, dev_q,
            branch_s, des_soc, gen_p_max, bus_v_magn, costs, network_collapsed,
        )

    def close(self):
        if self.is_rendering:
            from ..render import rendering

            try:
                rendering.close(self.http_server, self.ws_server)
            except AttributeError:
                pass
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
