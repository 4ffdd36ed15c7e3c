"""Online serving of GAME models.

Only the live introspection server is ported so far
(:mod:`photon_ml_tpu_torch.serving.introspect`: ``/metrics``, ``/healthz``,
``/varz``, ``/quitquitquit``), which ``train_game --introspect-port``
serves. The scorer, tables, caches, batchers, admission, hot swap and
overload control of ``photon_ml_tpu/serving`` are ROADMAP.md Queue A
item 9.
"""

from photon_ml_tpu_torch.serving.introspect import IntrospectionServer, prometheus_text

__all__ = ["IntrospectionServer", "prometheus_text"]
