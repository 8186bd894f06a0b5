"""K8s API plumbing of the operator (the port's copy of
``k8s_tpu/api``): the object model, the in-memory cluster, the typed
clients, the informer, the REST backend and wire, the dev apiserver,
and leader election."""
