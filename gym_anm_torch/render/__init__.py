"""Browser-based rendering subsystem.

Port of ``gym_anm_tpu.render``, which is stdlib only and carries over
unchanged in behaviour: ``client.render_page`` returns the same bytes.  A
stdlib replacement for the reference's rendering stack
(``gym_anm/envs/anm6_env/rendering/``): a threaded HTTP server serving a
self-contained SVG dashboard, an RFC 6455 WebSocket broadcast hub, and the
``start``/``update``/``close`` entry points environments call.  Unlike the
reference's ANM6-only hand-drawn SVG, the dashboard builds its one-line
diagram from the init message's topology, so any network renders.
"""

from . import rendering
from .http_server import HttpServer
from .rendering import close, feeder_layout, start, update
from .ws import WsClient, WsServer

__all__ = [
    "rendering",
    "start",
    "update",
    "close",
    "feeder_layout",
    "HttpServer",
    "WsServer",
    "WsClient",
]
