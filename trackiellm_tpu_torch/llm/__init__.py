"""The conversational LLM session: tokenizer, sampling, runner."""
