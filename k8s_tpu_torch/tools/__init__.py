"""Command-line tools of the port's operator: ``kubectl_local`` and the
``LocalWorld`` it runs."""
