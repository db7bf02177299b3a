"""Host half of the pipeline: event streams -> packed windows -> batches."""
