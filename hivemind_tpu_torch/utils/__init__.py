"""Host-side helpers of the port: logging, asyncio, time, tensor schemas, devices."""
