"""Collaborative ALBERT pretraining: ``run_trainer`` (a training peer),
``run_training_monitor`` (an observer) and ``data`` (the batches)."""
