"""AR and NAR engines and the synthesis pipeline."""
