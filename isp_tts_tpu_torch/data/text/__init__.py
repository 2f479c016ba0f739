"""Character text path: cleaners, symbols, coding table, processor."""
