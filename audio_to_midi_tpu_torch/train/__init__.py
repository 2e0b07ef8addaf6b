"""Training: loss, optimizer, the step, the loop, evaluation, checkpoints,
the population's evolution and the init surgery.

Counterpart of ``audio_to_midi_tpu/train/`` (``loss.py``, ``optim.py``,
``step.py``, ``loop.py``, ``evaluate.py``, ``checkpoint.py``,
``ensemble.py``, ``init_surgery.py``).
"""
