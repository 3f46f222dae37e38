"""Expert serving: ModuleBackend → TaskPool → Runtime, and the Llama checkpoint loader."""
