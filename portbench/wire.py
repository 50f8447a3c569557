"""The client side of the wire: a channel and raw unary calls on the
frozen proto copy. Imports grpc, numpy and `portbench.proto` only, never
torch or the program. Requests are serialized before the window where
the traffic allows it, so a call costs the client one bytes write."""

from __future__ import annotations

import grpc

from portbench.proto import scintirete_pb2 as pb

SERVICE = "scintirete.v1.ScintireteService"
OPTIONS = [
    ("grpc.max_receive_message_length", 256 * 1024 * 1024),
    ("grpc.max_send_message_length", 256 * 1024 * 1024),
]
# a request that has not answered in this many seconds has failed; an
# answer that comes late but within it counts with its whole wait
DEADLINE_S = 60.0

RESPONSES = {
    "Search": pb.SearchResponse,
    "BatchSearch": pb.BatchSearchResponse,
    "InsertVectors": pb.InsertVectorsResponse,
}


class Connection:
    """One client's channel, with a call per method that takes the
    serialized request and returns the parsed response."""

    def __init__(self, address: str):
        self.channel = grpc.insecure_channel(address, options=OPTIONS)
        self.calls = {
            m: self.channel.unary_unary(
                f"/{SERVICE}/{m}", request_serializer=None,
                response_deserializer=cls.FromString,
            )
            for m, cls in RESPONSES.items()
        }

    def close(self) -> None:
        self.channel.close()


def auth(password: str) -> pb.AuthInfo:
    return pb.AuthInfo(password=password)
