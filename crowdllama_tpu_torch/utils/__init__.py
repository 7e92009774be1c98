"""Framework-free helpers: crypto, identity keys, asyncio loops."""
