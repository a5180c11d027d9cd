"""Input-schema constants.

The network input dictionary uses the same column layout as the reference
(``gym_anm/simulator/components/constants.py:1-49``): a ``bus`` table, a
``device`` table and a ``branch`` table, each a 2-D array whose columns are
indexed by the maps below.
"""

_BUS_HEADERS = ("BUS_ID", "BUS_TYPE", "BASE_KV", "VMAX", "VMIN")

_DEV_HEADERS = (
    "DEV_ID",
    "BUS_ID",
    "DEV_TYPE",
    "Q/P",
    "PMAX",
    "PMIN",
    "QMAX",
    "QMIN",
    "P+",
    "P-",
    "Q+",
    "Q-",
    "SOC_MAX",
    "SOC_MIN",
    "EFF",
)

_BRANCH_HEADERS = ("F_BUS", "T_BUS", "BR_R", "BR_X", "BR_B", "RATE", "TAP", "SHIFT")

BUS_H = {h: i for i, h in enumerate(_BUS_HEADERS)}
"""Bus column index map."""

DEV_H = {h: i for i, h in enumerate(_DEV_HEADERS)}
"""Device column index map."""

BRANCH_H = {h: i for i, h in enumerate(_BRANCH_HEADERS)}
"""Branch column index map."""

# Device types (DEV_TYPE column):
#   -1 load, 0 slack generator, 1 classical generator, 2 renewable generator,
#    3 storage unit (DES), 4 capacitor bank, 5 on-load tap changer (OLTC).
DEV_TYPE_LOAD = -1
DEV_TYPE_SLACK = 0
DEV_TYPE_CLASSICAL_GEN = 1
DEV_TYPE_RENEWABLE_GEN = 2
DEV_TYPE_STORAGE = 3
DEV_TYPE_CAPACITOR = 4
DEV_TYPE_OLTC = 5

ALLOWED_DEV_TYPES = (
    DEV_TYPE_LOAD,
    DEV_TYPE_SLACK,
    DEV_TYPE_CLASSICAL_GEN,
    DEV_TYPE_RENEWABLE_GEN,
    DEV_TYPE_STORAGE,
    DEV_TYPE_CAPACITOR,
    DEV_TYPE_OLTC,
)

# State variables that may appear in state/observation vectors, mapped to the
# units they support.  The first unit is the default when none is given
# (reference: constants.py:31-49 — including the quirk that `branch_i_magn`
# maps to the *string* "pu", making "p" and "u" valid units there too).
STATE_VARIABLES = {
    "bus_p": ("MW", "pu"),
    "bus_q": ("MVAr", "pu"),
    "bus_v_magn": ("pu", "kV"),
    "bus_v_ang": ("degree", "rad"),
    "bus_i_magn": ("pu", "kA"),
    "bus_i_ang": ("degree", "rad"),
    "dev_p": ("MW", "pu"),
    "dev_q": ("MVAr", "pu"),
    "des_soc": ("MWh", "pu"),
    "gen_p_max": ("MW", "pu"),
    "branch_p": ("MW", "pu"),
    "branch_q": ("MVAr", "pu"),
    "branch_s": ("MVA", "pu"),
    "branch_i_magn": ("pu"),
    "branch_i_ang": ("degree", "rad"),
    "aux": (None,),
}
