"""All error types raised by :mod:`gym_anm_torch`.

Mirrors the error taxonomy of the reference implementation
(``gym_anm/errors.py:1-47`` and ``gym_anm/simulator/components/errors.py:1-62``)
so that user code catching these exceptions keeps working unchanged.
"""


# ---------------------------------------------------------------------------
# Environment-configuration errors (reference: gym_anm/errors.py)
# ---------------------------------------------------------------------------
class ANMEnvConfigurationError(Exception):
    """Base class for errors in the construction of an environment."""


class ArgsError(ANMEnvConfigurationError):
    """Raised when one of the environment arguments is invalid."""


class ObsSpaceError(ANMEnvConfigurationError):
    """Raised when the observation space is not properly specified."""


class ObsNotSupportedError(ObsSpaceError):
    """Raised when an element of the observation vector is unsupported."""

    def __init__(self, wanted, allowed):
        super().__init__(
            f"Observation type unsupported. Desired {wanted} but we only support {allowed}."
        )


class UnitsNotSupportedError(ObsSpaceError):
    """Raised when the unit requested for an observation is unsupported."""

    def __init__(self, wanted, allowed, key):
        super().__init__(
            f"Observation unit unsupported. Desired: {wanted} but we only support "
            f"{allowed} for observation {key}."
        )


class EnvInitializationError(ANMEnvConfigurationError):
    """Raised when the environment encounters a problem during reset()."""


class EnvNextVarsError(ANMEnvConfigurationError):
    """Raised when next_vars() returns an invalid vector."""


# ---------------------------------------------------------------------------
# Network-specification errors (reference: simulator/components/errors.py)
# ---------------------------------------------------------------------------
class InputNetworkFileError(Exception):
    """Base class for errors in the network input dictionary."""

    def __init__(self, message=""):
        super().__init__(message)


class BaseMVAError(InputNetworkFileError):
    """Raised when the network baseMVA is <= 0."""

    def __init__(self):
        super().__init__("The network baseMVA should be > 0.")


class BranchSpecError(InputNetworkFileError):
    """Raised when the specs of a branch are invalid."""


class BusSpecError(InputNetworkFileError):
    """Raised when the specs of a bus are invalid."""


class DeviceSpecError(InputNetworkFileError):
    """Raised when the specs of a device are invalid."""


class GenSpecError(DeviceSpecError):
    """Raised when the specs of a generator are invalid."""


class LoadSpecError(DeviceSpecError):
    """Raised when the specs of a load are invalid."""


class StorageSpecError(DeviceSpecError):
    """Raised when the specs of a storage unit are invalid."""


class PFEError(Exception):
    """Raised when no solution to the network equations is found."""


class UnitConversionError(Exception):
    """Raised when a conversion between units failed."""

    def __init__(self, old, new):
        super().__init__(f"Cannot convert from {old} units to {new} units")
