"""Environment-argument validation (port of ``gym_anm_tpu/compat/utils.py``;
reference: gym_anm/envs/utils.py:7-117)."""

from ..errors import ArgsError, ObsNotSupportedError, ObsSpaceError, UnitsNotSupportedError
from ..specs.constants import STATE_VARIABLES


def check_env_args(K, delta_t, lamb, gamma, observation, aux_bounds, state_bounds):
    """Raise if the environment arguments are invalid."""
    if K < 0:
        raise ArgsError("The argument K is %d but should be >= 0." % K)
    if delta_t <= 0:
        raise ArgsError("The argument delta_t is %.2f but should be > 0." % delta_t)
    if lamb < 0:
        raise ArgsError("The argument lamb is %d but should be >= 0." % lamb)
    if gamma < 0 or gamma > 1:
        raise ArgsError("The argument gamma is %.4f but should be in [0, 1]." % gamma)

    if isinstance(observation, str) and observation == "state":
        pass
    elif isinstance(observation, list):
        _check_observation_vars(observation, state_bounds, K)
    elif callable(observation):
        pass
    else:
        raise ArgsError(
            "The argument observation is of type {} but should be either a "
            'list, a callable, or the string "state".'.format(type(observation))
        )

    if aux_bounds is not None:
        if len(aux_bounds) != K:
            raise ArgsError(
                "The argument aux_bounds has length {} but the environment has "
                "K={} auxiliary variables.".format(len(aux_bounds), K)
            )


def _check_observation_vars(observation, state_bounds, K):
    """Validate a list-form observation specification."""
    for obs in observation:
        if len(obs) not in (2, 3):
            raise ObsSpaceError(
                "The observation tuple {} should be a list with 2 or 3 elements.".format(obs)
            )

        key = obs[0]
        if key not in STATE_VARIABLES.keys():
            raise ObsNotSupportedError(key, STATE_VARIABLES)

        nodes = obs[1]
        if isinstance(nodes, str) and nodes == "all":
            pass
        elif key == "aux":
            for n in nodes:
                if n >= K:
                    raise ObsSpaceError(
                        "Aux variable index {} is out of bound for {} aux variables.".format(n, K)
                    )
        elif isinstance(nodes, list):
            for n in nodes:
                if n not in state_bounds[key].keys():
                    raise ObsSpaceError(
                        "Observation {} is not supported for device/branch/bus "
                        "with ID {}.".format(key, n)
                    )
        else:
            raise ObsSpaceError()

        if len(obs) == 3:
            units = obs[2]
            if units not in STATE_VARIABLES[key]:
                raise UnitsNotSupportedError(units, STATE_VARIABLES[key], key)
