"""Zero-dependency interactive front end (stdlib ``http.server``).

The reference ships a Streamlit GUI (app.py:43-260: widget panel -> scene
build -> render -> image + elapsed/triangle-count readout).  Streamlit is
not installable without network access, so this module provides the same driver surface with the
standard library only: a form of render controls, a render-on-submit
endpoint, and the image + stats readout.

    python -m light_transport_tpu.gui [--port 8501] [--open]

Endpoints:
  GET /                     control panel + last render
  GET /render?preset=&...   run a render with the chosen controls
  GET /img.png              last rendered image (PNG bytes)

Everything renders through the same ``api.render`` path the CLI and tests
drive; the server is stateless except for the last-image buffer.
"""

from __future__ import annotations

import dataclasses
import html
import io
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PRESET_NAMES = ("lts", "glass", "mesh", "point")
INTEGRATORS = ("path", "adaptive", "whitted", "bdpt", "cv")
EMISSION_MODES = ("first_hit", "always", "nee", "mis")

_FORM = """<!doctype html>
<html><head><title>light_transport_tpu</title><style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; max-width: 60rem; }}
fieldset {{ border: 1px solid #ccc; margin-bottom: 1rem; }}
label {{ display: inline-block; margin: 0.3rem 1rem 0.3rem 0; }}
img {{ image-rendering: pixelated; border: 1px solid #888; }}
table {{ border-collapse: collapse; }} td, th {{ padding: 0.2rem 0.8rem;
border: 1px solid #ddd; text-align: left; }}
</style></head><body>
<h1>light_transport_tpu</h1>
<form action="/render" method="get">
<fieldset><legend>Scene &amp; integrator</legend>
<label>preset <select name="preset">{presets}</select></label>
<label>integrator <select name="integrator">{integrators}</select></label>
<label>emission <select name="emission_mode">{emissions}</select></label>
</fieldset>
<fieldset><legend>Image</legend>
<label>width <input name="width" type="number" value="{width}" min="8"
 max="1024"></label>
<label>height <input name="height" type="number" value="{height}" min="8"
 max="1024"></label>
<label>spp <input name="spp" type="number" value="{spp}" min="1"
 max="512"></label>
<label>depth <input name="max_depth" type="number" value="{depth}" min="1"
 max="16"></label>
<label>seed <input name="seed" type="number" value="{seed}"></label>
</fieldset>
<button type="submit">Render</button>
</form>
{result}
</body></html>"""


def _options(names, chosen):
    return "".join(
        f'<option value="{n}"{" selected" if n == chosen else ""}>{n}'
        f"</option>" for n in names
    )


def _png_bytes(img) -> bytes:
    import matplotlib
    import numpy as np

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    plt.imsave(buf, np.clip(np.asarray(img), 0.0, 1.0), format="png")
    return buf.getvalue()


class _State:
    png: bytes = b""
    stats: dict = {}


def run_render(params: dict) -> dict:
    """Render with the form parameters; returns the stats dict and stores
    the PNG in ``_State`` (separated from the handler for direct testing)."""
    import numpy as np

    from light_transport_tpu.api import render
    from light_transport_tpu.models import presets as P

    preset = params.get("preset", "lts")
    if preset not in PRESET_NAMES:
        raise ValueError(f"unknown preset {preset!r}")
    integrator = params.get("integrator", "path")
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    scene, cfg = P.PRESETS[preset]()
    # server-side clamps (the form's min/max don't bind a raw GET)
    caps = {"width": 1024, "height": 1024, "spp": 512, "max_depth": 16}
    over = {}
    for k, cap in caps.items():
        if params.get(k):
            over[k] = min(cap, max(1, int(params[k])))
    em = params.get("emission_mode")
    if em and em in EMISSION_MODES and integrator in ("path", "adaptive",
                                                      "cv"):
        over["emission_mode"] = em
    if over:
        cfg = dataclasses.replace(cfg, **over)
    seed = int(params.get("seed", 0) or 0)
    t0 = time.time()
    if integrator == "cv":
        # api.render has no cv branch (render_cv returns a telemetry
        # bundle, not an image) — route it like the CLI does (cli.py)
        import jax

        from light_transport_tpu.integrators.control_variates import (
            render_cv,
        )

        img = np.asarray(render_cv(scene, cfg, jax.random.key(seed))
                         .image_cv)
    else:
        img = np.asarray(render(scene, cfg, seed=seed,
                                integrator=integrator))
    dt = time.time() - t0
    _State.png = _png_bytes(img)
    _State.stats = {
        "preset": preset,
        "integrator": integrator,
        "size": f"{cfg.width}x{cfg.height}",
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        "seed": seed,
        "triangles": int(scene.mesh.v0.shape[0]),
        "elapsed_s": round(dt, 2),
        "mean": round(float(img.mean()), 4),
    }
    return _State.stats


def _page(params: dict) -> str:
    stats = _State.stats
    result = ""
    if stats:
        rows = "".join(
            f"<tr><th>{html.escape(str(k))}</th>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in stats.items()
        )
        # elapsed/triangle-count readout: the reference surfaces the same
        # stats after its render (app.py:253-256)
        result = (f'<h2>Render</h2><img src="/img.png?t={time.time()}" '
                  f'width="384"><table>{rows}</table>')
    return _FORM.format(
        presets=_options(PRESET_NAMES, params.get("preset", "lts")),
        integrators=_options(INTEGRATORS,
                             params.get("integrator", "path")),
        emissions=_options(EMISSION_MODES,
                           params.get("emission_mode", "first_hit")),
        width=params.get("width", 96),
        height=params.get("height", 96),
        spp=params.get("spp", 8),
        depth=params.get("max_depth", 4),
        seed=params.get("seed", 0),
        result=result,
    )


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _send(self, code, body, ctype="text/html; charset=utf-8"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        params = {k: v[0] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        try:
            if parsed.path == "/img.png":
                if not _State.png:
                    self._send(404, b"no render yet",
                               "text/plain; charset=utf-8")
                    return
                self._send(200, _State.png, "image/png")
            elif parsed.path == "/render":
                run_render(params)
                self._send(200, _page(params).encode())
            elif parsed.path == "/stats.json":
                self._send(200, json.dumps(_State.stats).encode(),
                           "application/json")
            else:
                self._send(200, _page(params).encode())
        except Exception as e:  # surface errors in the page, keep serving
            msg = f"<h1>error</h1><pre>{html.escape(repr(e))}</pre>"
            self._send(500, msg.encode())


def serve(port: int = 8501, host: str = "127.0.0.1",
          background: bool = False):
    """Start the GUI server.  ``background=True`` returns the server
    (running on a daemon thread) instead of blocking — used by tests."""
    srv = ThreadingHTTPServer((host, port), Handler)
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv
    print(f"light_transport_tpu GUI on http://{host}:{srv.server_port}/ "
          f"(ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return srv


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="light_transport_tpu.gui")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)
    serve(args.port, args.host)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
