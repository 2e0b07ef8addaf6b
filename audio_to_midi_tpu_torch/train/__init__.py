"""Training: loss, optimizer and the training step.

Counterpart of ``audio_to_midi_tpu/train/`` (``loss.py``, ``optim.py``,
``step.py``).  The loop, the input ring, evaluation, checkpoints and the
ensemble axis are not ported yet.
"""
