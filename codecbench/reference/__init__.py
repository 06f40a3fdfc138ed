"""The plain reference: numpy only, nothing of the codec under test."""
