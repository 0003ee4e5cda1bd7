"""Training on the port: AdamW, the train step, gradient wire
compression and the elastic actor-learner fabric — the port of
``repro.train``."""
