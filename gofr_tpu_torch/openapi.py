"""OpenAPI spec serving + Swagger UI (reference pkg/gofr/swagger.go; the
port's copy of ``gofr_tpu/openapi.py``).

Two modes, auto-registered at ``/.well-known/*`` like the reference
(swagger.go:59-70):

- **file mode** (reference parity): if ``./static/openapi.json``
  exists, it is served verbatim at ``/.well-known/openapi.json``
  (swagger.go:24-35 reads the file from disk per request, so edits
  show up without a restart).
- **generated mode** (no reference counterpart): otherwise the spec is
  generated from the app's live route table — every registered route
  becomes a path item, ``{param}`` segments become path parameters,
  and model-serving routes get typed request/response schemas.

The UI at ``/.well-known/swagger`` is a self-contained offline HTML
page (no CDN assets — the deployment may have zero egress) that
fetches the JSON spec and renders an interactive route explorer with
try-it-out requests.
"""

from __future__ import annotations

import json
import os
from typing import Any

from .http.response import File, Raw

OPENAPI_JSON = "openapi.json"
WELL_KNOWN_SPEC = f"/.well-known/{OPENAPI_JSON}"
WELL_KNOWN_UI = "/.well-known/swagger"

_SKIP_PATHS = {"/.well-known/health", "/.well-known/alive",
               WELL_KNOWN_SPEC, WELL_KNOWN_UI, "/favicon.ico"}

_STATUS_BY_METHOD = {"POST": "201", "DELETE": "204"}


def generate_spec(app: Any) -> dict:
    """Build an OpenAPI 3.0 document from the live route table."""
    paths: dict[str, dict] = {}
    for route in app.router.routes:
        if route.pattern in _SKIP_PATHS:
            continue
        item = paths.setdefault(route.pattern, {})
        op: dict[str, Any] = {
            "summary": (getattr(route.handler, "__doc__", None) or
                        f"{route.method} {route.pattern}").strip()
                       .split("\n")[0],
            "operationId": f"{route.method.lower()}_"
                           + route.pattern.strip("/").replace("/", "_")
                             .replace("{", "").replace("}", "") ,
            "responses": {
                _STATUS_BY_METHOD.get(route.method, "200"): {
                    "description": "success",
                    "content": {"application/json": {"schema": {
                        "$ref": "#/components/schemas/Envelope"}}},
                }
            },
        }
        params = [{"name": seg[1:-1], "in": "path", "required": True,
                   "schema": {"type": "string"}}
                  for seg in route.segments
                  if seg.startswith("{") and seg.endswith("}")]
        if params:
            op["parameters"] = params
        if route.method in ("POST", "PUT", "PATCH"):
            op["requestBody"] = {"content": {"application/json": {
                "schema": {"type": "object"}}}}
        item[route.method.lower()] = op

    # health endpoints documented explicitly
    paths["/.well-known/health"] = {"get": {
        "summary": "Aggregate health of every datasource, service and "
                   "device runtime",
        "responses": {"200": {"description": "UP or DEGRADED"}}}}
    paths["/.well-known/alive"] = {"get": {
        "summary": "Liveness probe",
        "responses": {"200": {"description": "alive"}}}}

    container = getattr(app, "container", None)
    return {
        "openapi": "3.0.3",
        "info": {
            "title": getattr(container, "app_name", "gofr-tpu app"),
            "version": getattr(container, "app_version", "dev"),
        },
        "paths": dict(sorted(paths.items())),
        "components": {"schemas": {
            "Envelope": {
                "type": "object",
                "properties": {
                    "data": {},
                    "error": {"type": "object", "properties": {
                        "message": {"type": "string"}}},
                    "metadata": {"type": "object"},
                },
            },
        }},
    }


def make_openapi_handler(app: Any, static_dir: str = "static"):
    """File mode when ./static/openapi.json exists, else generated."""

    def openapi_handler(ctx: Any) -> Any:
        path = os.path.join(static_dir, OPENAPI_JSON)
        if os.path.isfile(path):
            with open(path, "rb") as f:  # re-read per request, like the ref
                return File(content=f.read(),
                            content_type="application/json")
        return Raw(generate_spec(app))
    return openapi_handler


_UI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title} — API</title><style>
body{{font-family:system-ui,sans-serif;margin:0;background:#fafafa;color:#1a1a1a}}
header{{background:#1a237e;color:#fff;padding:14px 24px;font-size:18px}}
main{{max-width:920px;margin:24px auto;padding:0 16px}}
.op{{background:#fff;border:1px solid #ddd;border-radius:6px;margin:10px 0}}
.op summary{{padding:10px 14px;cursor:pointer;display:flex;gap:12px;align-items:center}}
.m{{font-weight:700;min-width:60px;text-align:center;border-radius:4px;padding:3px 0;color:#fff;font-size:13px}}
.GET{{background:#1976d2}}.POST{{background:#388e3c}}.PUT{{background:#f57c00}}
.PATCH{{background:#7b1fa2}}.DELETE{{background:#d32f2f}}
.body{{padding:10px 14px;border-top:1px solid #eee}}
textarea,input{{width:100%;box-sizing:border-box;font-family:monospace;margin:4px 0}}
pre{{background:#263238;color:#c3e88d;padding:10px;border-radius:4px;overflow:auto;max-height:320px}}
button{{background:#1a237e;color:#fff;border:0;border-radius:4px;padding:6px 14px;cursor:pointer}}
small{{color:#777}}</style></head><body>
<header>{title} <small style="color:#9fa8da">v{version} — OpenAPI explorer</small></header>
<main id="ops">loading spec…</main>
<script>
fetch("{spec_url}").then(r=>r.json()).then(spec=>{{
  const main=document.getElementById("ops");main.innerHTML="";
  for(const [path,item] of Object.entries(spec.paths||{{}})){{
    for(const [method,op] of Object.entries(item)){{
      const d=document.createElement("details");d.className="op";
      const M=method.toUpperCase();
      d.innerHTML=`<summary><span class="m ${{M}}">${{M}}</span>`+
        `<code>${{path}}</code> <small>${{op.summary||""}}</small></summary>`+
        `<div class="body"><div class="params"></div>`+
        (op.requestBody?`<textarea rows=4 class="reqbody">{{}}</textarea>`:"")+
        `<button>Try it</button><pre hidden></pre></div>`;
      const params=op.parameters||[];
      const pdiv=d.querySelector(".params");
      for(const p of params){{
        pdiv.insertAdjacentHTML("beforeend",
          `<label>${{p.name}} <input data-name="${{p.name}}"></label>`);
      }}
      d.querySelector("button").onclick=async()=>{{
        let url=path;
        for(const inp of d.querySelectorAll("input[data-name]"))
          url=url.replace("{{"+inp.dataset.name+"}}",encodeURIComponent(inp.value));
        const init={{method:M}};
        const ta=d.querySelector(".reqbody");
        if(ta){{init.body=ta.value;init.headers={{"Content-Type":"application/json"}}}}
        const pre=d.querySelector("pre");pre.hidden=false;
        try{{const r=await fetch(url,init);
          const text=await r.text();
          let shown=text;try{{shown=JSON.stringify(JSON.parse(text),null,2)}}catch(e){{}}
          pre.textContent=r.status+" "+r.statusText+"\\n"+shown;
        }}catch(e){{pre.textContent="request failed: "+e}}
      }};
      main.appendChild(d);
    }}
  }}
}}).catch(e=>{{document.getElementById("ops").textContent="failed to load spec: "+e}});
</script></body></html>"""


def make_swagger_ui_handler(app: Any):
    def swagger_ui_handler(ctx: Any) -> Any:
        container = getattr(app, "container", None)
        html = _UI_HTML.format(
            title=getattr(container, "app_name", "gofr-tpu app"),
            version=getattr(container, "app_version", "dev"),
            spec_url=WELL_KNOWN_SPEC)
        return File(content=html.encode(), content_type="text/html")
    return swagger_ui_handler


def register(app: Any, static_dir: str = "static") -> None:
    """Install the spec + UI routes (reference swagger.go:59-70 gates on
    the file existing; generated mode means we always have a spec)."""
    app.router.add("GET", WELL_KNOWN_SPEC, make_openapi_handler(app, static_dir))
    app.router.add("GET", WELL_KNOWN_UI, make_swagger_ui_handler(app))
