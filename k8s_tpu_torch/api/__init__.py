"""K8s API plumbing of the operator (the port's copy of
``k8s_tpu/api``): the object model, the in-memory cluster, the typed
clients and the informer. The REST backend, the dev apiserver and
leader election are a later slice (ROADMAP A12.2)."""
