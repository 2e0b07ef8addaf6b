"""Training: loss, optimizer, the step, the loop, evaluation and checkpoints.

Counterpart of ``audio_to_midi_tpu/train/`` (``loss.py``, ``optim.py``,
``step.py``, ``loop.py``, ``evaluate.py``, ``checkpoint.py``).  The
ensemble axis and init surgery are not ported yet.
"""
