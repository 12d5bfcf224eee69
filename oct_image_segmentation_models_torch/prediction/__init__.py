"""Volume-streaming inference."""
