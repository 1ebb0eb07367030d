"""The web dashboard: one static page, no build step.

The port's copy of ``rafiki_tpu/web``: login, datasets (upload and
list), models, train jobs with their trials' live charts (drawn from
``GET /trials/<id>/logs``), services and their logs, inference jobs
with their serving stats, users, traces, trial phases, and the
autoscaler, SLO and capacity panels, all over the admin REST API. The
admin serves it at ``GET /``.
"""

import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def dashboard_html() -> str:
    with open(os.path.join(_HERE, "dashboard.html"), encoding="utf-8") as f:
        return f.read()


__all__ = ["dashboard_html"]
