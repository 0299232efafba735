"""Speech recognition: Whisper, for transcript-less prompt making."""
