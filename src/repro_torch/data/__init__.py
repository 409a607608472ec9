"""Synthetic batches and trace token realisation."""
from repro_torch.data.pipeline import (BatchSpec, SyntheticLM, batch_spec_for,
                                       realize_request_tokens)
