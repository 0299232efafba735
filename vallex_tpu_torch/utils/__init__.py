"""Parameter files, WAV I/O and Whisper transcription."""
