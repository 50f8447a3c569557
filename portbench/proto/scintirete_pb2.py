# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: scintirete.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10scintirete.proto\x12\rscintirete.v1\x1a\x1cgoogle/protobuf/struct.proto\"0\n\nHnswConfig\x12\t\n\x01m\x18\x01 \x01(\x05\x12\x17\n\x0f\x65\x66_construction\x18\x02 \x01(\x05\"]\n\x06Vector\x12\x0f\n\x02id\x18\x01 \x01(\x04H\x00\x88\x01\x01\x12\x10\n\x08\x65lements\x18\x02 \x03(\x02\x12)\n\x08metadata\x18\x03 \x01(\x0b\x32\x17.google.protobuf.StructB\x05\n\x03_id\"c\n\x10TextWithMetadata\x12\x0f\n\x02id\x18\x01 \x01(\x04H\x00\x88\x01\x01\x12\x0c\n\x04text\x18\x02 \x01(\t\x12)\n\x08metadata\x18\x03 \x01(\x0b\x32\x17.google.protobuf.StructB\x05\n\x03_id\"\x92\x01\n\x10SearchResultItem\x12*\n\x06vector\x18\x01 \x01(\x0b\x32\x15.scintirete.v1.VectorH\x00\x88\x01\x01\x12\x10\n\x08\x64istance\x18\x02 \x01(\x02\x12\n\n\x02id\x18\x03 \x01(\x04\x12)\n\x08metadata\x18\x04 \x01(\x0b\x32\x17.google.protobuf.StructB\t\n\x07_vector\"\xec\x01\n\x0e\x43ollectionInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdimension\x18\x02 \x01(\x05\x12\x14\n\x0cvector_count\x18\x03 \x01(\x03\x12\x15\n\rdeleted_count\x18\x04 \x01(\x03\x12\x14\n\x0cmemory_bytes\x18\x05 \x01(\x03\x12\x32\n\x0bmetric_type\x18\x06 \x01(\x0e\x32\x1d.scintirete.v1.DistanceMetric\x12.\n\x0bhnsw_config\x18\x07 \x01(\x0b\x32\x19.scintirete.v1.HnswConfig\x12\x12\n\nindex_type\x18\x08 \x01(\t\"\x1c\n\x08\x41uthInfo\x12\x10\n\x08password\x18\x01 \x01(\t\"L\n\x15\x43reateDatabaseRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0c\n\x04name\x18\x02 \x01(\t\"H\n\x16\x43reateDatabaseResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07success\x18\x02 \x01(\x08\x12\x0f\n\x07message\x18\x03 \x01(\t\"J\n\x13\x44ropDatabaseRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0c\n\x04name\x18\x02 \x01(\t\"c\n\x14\x44ropDatabaseResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07success\x18\x02 \x01(\x08\x12\x0f\n\x07message\x18\x03 \x01(\t\x12\x1b\n\x13\x64ropped_collections\x18\x04 \x01(\x05\"=\n\x14ListDatabasesRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\"&\n\x15ListDatabasesResponse\x12\r\n\x05names\x18\x01 \x03(\t\"\xf7\x01\n\x17\x43reateCollectionRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\x12\x32\n\x0bmetric_type\x18\x04 \x01(\x0e\x32\x1d.scintirete.v1.DistanceMetric\x12\x33\n\x0bhnsw_config\x18\x05 \x01(\x0b\x32\x19.scintirete.v1.HnswConfigH\x00\x88\x01\x01\x12\x12\n\nindex_type\x18\x06 \x01(\tB\x0e\n\x0c_hnsw_config\"\x93\x01\n\x18\x43reateCollectionResponse\x12\x0f\n\x07\x64\x62_name\x18\x01 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x02 \x01(\t\x12\x0f\n\x07success\x18\x03 \x01(\x08\x12\x0f\n\x07message\x18\x04 \x01(\t\x12+\n\x04info\x18\x05 \x01(\x0b\x32\x1d.scintirete.v1.CollectionInfo\"h\n\x15\x44ropCollectionRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\"}\n\x16\x44ropCollectionResponse\x12\x0f\n\x07\x64\x62_name\x18\x01 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x02 \x01(\t\x12\x0f\n\x07success\x18\x03 \x01(\x08\x12\x0f\n\x07message\x18\x04 \x01(\t\x12\x17\n\x0f\x64ropped_vectors\x18\x05 \x01(\x03\"k\n\x18GetCollectionInfoRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\"P\n\x16ListCollectionsRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\"M\n\x17ListCollectionsResponse\x12\x32\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x1d.scintirete.v1.CollectionInfo\"\x8f\x01\n\x14InsertVectorsRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\x12&\n\x07vectors\x18\x04 \x03(\x0b\x32\x15.scintirete.v1.Vector\"E\n\x15InsertVectorsResponse\x12\x14\n\x0cinserted_ids\x18\x01 \x03(\x04\x12\x16\n\x0einserted_count\x18\x02 \x01(\x05\"t\n\x14\x44\x65leteVectorsRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\x12\x0b\n\x03ids\x18\x04 \x03(\x04\".\n\x15\x44\x65leteVectorsResponse\x12\x15\n\rdeleted_count\x18\x01 \x01(\x05\"\xdb\x01\n\rSearchRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\x12\x14\n\x0cquery_vector\x18\x04 \x03(\x02\x12\r\n\x05top_k\x18\x05 \x01(\x05\x12\x16\n\tef_search\x18\x06 \x01(\x05H\x00\x88\x01\x01\x12\x1b\n\x0einclude_vector\x18\x07 \x01(\x08H\x01\x88\x01\x01\x42\x0c\n\n_ef_searchB\x11\n\x0f_include_vector\"B\n\x0eSearchResponse\x12\x30\n\x07results\x18\x01 \x03(\x0b\x32\x1f.scintirete.v1.SearchResultItem\"\xca\x01\n\x15\x45mbedAndInsertRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\x12.\n\x05texts\x18\x04 \x03(\x0b\x32\x1f.scintirete.v1.TextWithMetadata\x12\x1c\n\x0f\x65mbedding_model\x18\x05 \x01(\tH\x00\x88\x01\x01\x42\x12\n\x10_embedding_model\"F\n\x16\x45mbedAndInsertResponse\x12\x14\n\x0cinserted_ids\x18\x01 \x03(\x04\x12\x16\n\x0einserted_count\x18\x02 \x01(\x05\"z\n\x10\x45mbedTextRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\r\n\x05texts\x18\x02 \x03(\t\x12\x1c\n\x0f\x65mbedding_model\x18\x03 \x01(\tH\x00\x88\x01\x01\x42\x12\n\x10_embedding_model\"D\n\x11\x45mbedTextResponse\x12/\n\x07results\x18\x01 \x03(\x0b\x32\x1e.scintirete.v1.EmbedTextResult\"A\n\x0f\x45mbedTextResult\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x11\n\tembedding\x18\x02 \x03(\x02\x12\r\n\x05index\x18\x03 \x01(\x05\"C\n\x1aListEmbeddingModelsRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\"c\n\x1bListEmbeddingModelsResponse\x12-\n\x06models\x18\x01 \x03(\x0b\x32\x1d.scintirete.v1.EmbeddingModel\x12\x15\n\rdefault_model\x18\x02 \x01(\t\"e\n\x0e\x45mbeddingModel\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x11\n\tdimension\x18\x03 \x01(\x05\x12\x11\n\tavailable\x18\x04 \x01(\x08\x12\x13\n\x0b\x64\x65scription\x18\x05 \x01(\t\"\x93\x02\n\x15\x45mbedAndSearchRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\x12\x12\n\nquery_text\x18\x04 \x01(\t\x12\r\n\x05top_k\x18\x05 \x01(\x05\x12\x1c\n\x0f\x65mbedding_model\x18\x06 \x01(\tH\x00\x88\x01\x01\x12\x16\n\tef_search\x18\x07 \x01(\x05H\x01\x88\x01\x01\x12\x1b\n\x0einclude_vector\x18\x08 \x01(\x08H\x02\x88\x01\x01\x42\x12\n\x10_embedding_modelB\x0c\n\n_ef_searchB\x11\n\x0f_include_vector\"4\n\x0bSaveRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\"a\n\x0cSaveResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x15\n\rsnapshot_size\x18\x03 \x01(\x03\x12\x18\n\x10\x64uration_seconds\x18\x04 \x01(\x01\"6\n\rBgSaveRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\"B\n\x0e\x42gSaveResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x0e\n\x06job_id\x18\x03 \x01(\t\"\xe3\x01\n\x12\x42\x61tchSearchRequest\x12%\n\x04\x61uth\x18\x01 \x01(\x0b\x32\x17.scintirete.v1.AuthInfo\x12\x0f\n\x07\x64\x62_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63ollection_name\x18\x03 \x01(\t\x12\x16\n\x0equeries_packed\x18\x04 \x01(\x0c\x12\x13\n\x0bnum_queries\x18\x05 \x01(\x05\x12\x0b\n\x03\x64im\x18\x06 \x01(\x05\x12\r\n\x05top_k\x18\x07 \x01(\x05\x12\x16\n\tef_search\x18\x08 \x01(\x05H\x00\x88\x01\x01\x12\r\n\x05\x64type\x18\t \x01(\tB\x0c\n\n_ef_search\"g\n\x13\x42\x61tchSearchResponse\x12\x12\n\nids_packed\x18\x01 \x01(\x0c\x12\x18\n\x10\x64istances_packed\x18\x02 \x01(\x0c\x12\x13\n\x0bnum_queries\x18\x03 \x01(\x05\x12\r\n\x05top_k\x18\x04 \x01(\x05*X\n\x0e\x44istanceMetric\x12\x1f\n\x1b\x44ISTANCE_METRIC_UNSPECIFIED\x10\x00\x12\x06\n\x02L2\x10\x01\x12\n\n\x06\x43OSINE\x10\x02\x12\x11\n\rINNER_PRODUCT\x10\x03\x32\xfb\x0b\n\x11ScintireteService\x12]\n\x0e\x43reateDatabase\x12$.scintirete.v1.CreateDatabaseRequest\x1a%.scintirete.v1.CreateDatabaseResponse\x12W\n\x0c\x44ropDatabase\x12\".scintirete.v1.DropDatabaseRequest\x1a#.scintirete.v1.DropDatabaseResponse\x12Z\n\rListDatabases\x12#.scintirete.v1.ListDatabasesRequest\x1a$.scintirete.v1.ListDatabasesResponse\x12\x63\n\x10\x43reateCollection\x12&.scintirete.v1.CreateCollectionRequest\x1a\'.scintirete.v1.CreateCollectionResponse\x12]\n\x0e\x44ropCollection\x12$.scintirete.v1.DropCollectionRequest\x1a%.scintirete.v1.DropCollectionResponse\x12[\n\x11GetCollectionInfo\x12\'.scintirete.v1.GetCollectionInfoRequest\x1a\x1d.scintirete.v1.CollectionInfo\x12`\n\x0fListCollections\x12%.scintirete.v1.ListCollectionsRequest\x1a&.scintirete.v1.ListCollectionsResponse\x12Z\n\rInsertVectors\x12#.scintirete.v1.InsertVectorsRequest\x1a$.scintirete.v1.InsertVectorsResponse\x12Z\n\rDeleteVectors\x12#.scintirete.v1.DeleteVectorsRequest\x1a$.scintirete.v1.DeleteVectorsResponse\x12\x45\n\x06Search\x12\x1c.scintirete.v1.SearchRequest\x1a\x1d.scintirete.v1.SearchResponse\x12]\n\x0e\x45mbedAndInsert\x12$.scintirete.v1.EmbedAndInsertRequest\x1a%.scintirete.v1.EmbedAndInsertResponse\x12U\n\x0e\x45mbedAndSearch\x12$.scintirete.v1.EmbedAndSearchRequest\x1a\x1d.scintirete.v1.SearchResponse\x12N\n\tEmbedText\x12\x1f.scintirete.v1.EmbedTextRequest\x1a .scintirete.v1.EmbedTextResponse\x12l\n\x13ListEmbeddingModels\x12).scintirete.v1.ListEmbeddingModelsRequest\x1a*.scintirete.v1.ListEmbeddingModelsResponse\x12?\n\x04Save\x12\x1a.scintirete.v1.SaveRequest\x1a\x1b.scintirete.v1.SaveResponse\x12\x45\n\x06\x42gSave\x12\x1c.scintirete.v1.BgSaveRequest\x1a\x1d.scintirete.v1.BgSaveResponse\x12T\n\x0b\x42\x61tchSearch\x12!.scintirete.v1.BatchSearchRequest\x1a\".scintirete.v1.BatchSearchResponseBDZBgithub.com/scintirete/scintirete/gen/go/scintirete/v1;scintiretev1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'scintirete_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'ZBgithub.com/scintirete/scintirete/gen/go/scintirete/v1;scintiretev1'
  _DISTANCEMETRIC._serialized_start=4438
  _DISTANCEMETRIC._serialized_end=4526
  _HNSWCONFIG._serialized_start=65
  _HNSWCONFIG._serialized_end=113
  _VECTOR._serialized_start=115
  _VECTOR._serialized_end=208
  _TEXTWITHMETADATA._serialized_start=210
  _TEXTWITHMETADATA._serialized_end=309
  _SEARCHRESULTITEM._serialized_start=312
  _SEARCHRESULTITEM._serialized_end=458
  _COLLECTIONINFO._serialized_start=461
  _COLLECTIONINFO._serialized_end=697
  _AUTHINFO._serialized_start=699
  _AUTHINFO._serialized_end=727
  _CREATEDATABASEREQUEST._serialized_start=729
  _CREATEDATABASEREQUEST._serialized_end=805
  _CREATEDATABASERESPONSE._serialized_start=807
  _CREATEDATABASERESPONSE._serialized_end=879
  _DROPDATABASEREQUEST._serialized_start=881
  _DROPDATABASEREQUEST._serialized_end=955
  _DROPDATABASERESPONSE._serialized_start=957
  _DROPDATABASERESPONSE._serialized_end=1056
  _LISTDATABASESREQUEST._serialized_start=1058
  _LISTDATABASESREQUEST._serialized_end=1119
  _LISTDATABASESRESPONSE._serialized_start=1121
  _LISTDATABASESRESPONSE._serialized_end=1159
  _CREATECOLLECTIONREQUEST._serialized_start=1162
  _CREATECOLLECTIONREQUEST._serialized_end=1409
  _CREATECOLLECTIONRESPONSE._serialized_start=1412
  _CREATECOLLECTIONRESPONSE._serialized_end=1559
  _DROPCOLLECTIONREQUEST._serialized_start=1561
  _DROPCOLLECTIONREQUEST._serialized_end=1665
  _DROPCOLLECTIONRESPONSE._serialized_start=1667
  _DROPCOLLECTIONRESPONSE._serialized_end=1792
  _GETCOLLECTIONINFOREQUEST._serialized_start=1794
  _GETCOLLECTIONINFOREQUEST._serialized_end=1901
  _LISTCOLLECTIONSREQUEST._serialized_start=1903
  _LISTCOLLECTIONSREQUEST._serialized_end=1983
  _LISTCOLLECTIONSRESPONSE._serialized_start=1985
  _LISTCOLLECTIONSRESPONSE._serialized_end=2062
  _INSERTVECTORSREQUEST._serialized_start=2065
  _INSERTVECTORSREQUEST._serialized_end=2208
  _INSERTVECTORSRESPONSE._serialized_start=2210
  _INSERTVECTORSRESPONSE._serialized_end=2279
  _DELETEVECTORSREQUEST._serialized_start=2281
  _DELETEVECTORSREQUEST._serialized_end=2397
  _DELETEVECTORSRESPONSE._serialized_start=2399
  _DELETEVECTORSRESPONSE._serialized_end=2445
  _SEARCHREQUEST._serialized_start=2448
  _SEARCHREQUEST._serialized_end=2667
  _SEARCHRESPONSE._serialized_start=2669
  _SEARCHRESPONSE._serialized_end=2735
  _EMBEDANDINSERTREQUEST._serialized_start=2738
  _EMBEDANDINSERTREQUEST._serialized_end=2940
  _EMBEDANDINSERTRESPONSE._serialized_start=2942
  _EMBEDANDINSERTRESPONSE._serialized_end=3012
  _EMBEDTEXTREQUEST._serialized_start=3014
  _EMBEDTEXTREQUEST._serialized_end=3136
  _EMBEDTEXTRESPONSE._serialized_start=3138
  _EMBEDTEXTRESPONSE._serialized_end=3206
  _EMBEDTEXTRESULT._serialized_start=3208
  _EMBEDTEXTRESULT._serialized_end=3273
  _LISTEMBEDDINGMODELSREQUEST._serialized_start=3275
  _LISTEMBEDDINGMODELSREQUEST._serialized_end=3342
  _LISTEMBEDDINGMODELSRESPONSE._serialized_start=3344
  _LISTEMBEDDINGMODELSRESPONSE._serialized_end=3443
  _EMBEDDINGMODEL._serialized_start=3445
  _EMBEDDINGMODEL._serialized_end=3546
  _EMBEDANDSEARCHREQUEST._serialized_start=3549
  _EMBEDANDSEARCHREQUEST._serialized_end=3824
  _SAVEREQUEST._serialized_start=3826
  _SAVEREQUEST._serialized_end=3878
  _SAVERESPONSE._serialized_start=3880
  _SAVERESPONSE._serialized_end=3977
  _BGSAVEREQUEST._serialized_start=3979
  _BGSAVEREQUEST._serialized_end=4033
  _BGSAVERESPONSE._serialized_start=4035
  _BGSAVERESPONSE._serialized_end=4101
  _BATCHSEARCHREQUEST._serialized_start=4104
  _BATCHSEARCHREQUEST._serialized_end=4331
  _BATCHSEARCHRESPONSE._serialized_start=4333
  _BATCHSEARCHRESPONSE._serialized_end=4436
  _SCINTIRETESERVICE._serialized_start=4529
  _SCINTIRETESERVICE._serialized_end=6060
# @@protoc_insertion_point(module_scope)
