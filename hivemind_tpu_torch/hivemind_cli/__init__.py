"""Command-line entry points of the port: ``run_dht`` (a bootstrap DHT node) and
``run_server`` (an expert or Llama block server)."""
