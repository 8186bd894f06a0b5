"""The program side of the observability layer (port of ``k8s_tpu/obs``):
tracing and the flight recorder (:mod:`.trace`), the structured-event
parser (:mod:`.events`), pushed heartbeats (:mod:`.push`), and the
nan-grad chaos arm and device telemetry (:mod:`.health`).

:mod:`.trace`, :mod:`.events` and :mod:`.push` are stdlib only;
:mod:`.health` imports ``torch`` inside the functions that read the
device. The reconciler's half (``HealthMonitor``, ``StragglerDetector``)
stays with the operator.
"""
