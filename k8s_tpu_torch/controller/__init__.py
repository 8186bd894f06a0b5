"""The operator's controller layer (the port's copy of
``k8s_tpu/controller``): the watch loop and dispatch
(:mod:`.controller`), the shared reconciler core and its work queue
(:mod:`.reconciler`, :mod:`.workqueue`), the watchdog, the status
poller, the metrics registry (:mod:`.metrics`) and the obs HTTP
endpoint (:mod:`.health`). Importing the package loads none of them,
so a training program's import of the metrics stays light."""
