"""Web remote UI: binary WebSocket protocol + asyncio server + browser client."""
