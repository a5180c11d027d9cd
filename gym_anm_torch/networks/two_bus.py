"""A 2-bus grid: slack generator (bus 0) --- load (bus 1).

Same topology and parameters as the reference's example environment
(``examples/simple_env.py:20-30``).
"""

import numpy as np

network = {
    "baseMVA": 100,
    "bus": np.array(
        [
            [0, 0, 132, 1.0, 1.0],
            [1, 1, 33, 1.1, 0.9],
        ]
    ),
    "device": np.array(
        [
            [0, 0, 0, None, 200, -200, 200, -200, None, None, None, None, None, None, None],
            [1, 1, -1, 0.2, 0, -10, None, None, None, None, None, None, None, None, None],
        ],
        dtype=object,
    ),
    "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 3, 1, 0]]),
}
