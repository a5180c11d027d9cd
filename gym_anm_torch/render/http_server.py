"""Threaded HTTP server for the rendering dashboard (pure stdlib).

Port of ``gym_anm_tpu/render/http_server.py``, unchanged in behaviour.
Replacement for the reference's forked ``SimpleHTTPRequestHandler`` process
(``rendering/py/servers.py:144-196``); serves the generated single-page
dashboard from memory instead of writing an html file into the package
tree (the reference's ``write_html`` rewrites ``index.html`` on every
``start()``, rendering.py:62-86).
"""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class HttpServer:
    def __init__(self, html: bytes, host="127.0.0.1", port=0):
        page = html

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)

            def log_message(self, *args):
                pass  # silence per-request logging

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self.address = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
