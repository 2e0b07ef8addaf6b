"""PyTorch and CUDA port of ``audio_to_midi_tpu`` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its layout module by
module and imports ``torch`` and never ``jax``.  The serving path (audio file
-> MIDI) runs here: ``infer.transcribe_file`` and ``cli/audio_to_midi.py``;
so does training: ``train/loop.py`` and ``cli/train_cli.py``.
"""
