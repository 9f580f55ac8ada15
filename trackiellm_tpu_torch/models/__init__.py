"""Model forwards (the Mistral slice of ``trackiellm_tpu.models``)."""
