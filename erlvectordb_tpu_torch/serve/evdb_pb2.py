# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: evdb.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nevdb.proto\x12\x04\x65vdb\"\x07\n\x05\x45mpty\"*\n\x0bStatusReply\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\"\x18\n\x08StoreRef\x12\x0c\n\x04name\x18\x01 \x01(\t\"i\n\x12\x43reateStoreRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdimension\x18\x02 \x01(\r\x12\x0e\n\x06metric\x18\x03 \x01(\t\x12\r\n\x05\x64type\x18\x04 \x01(\t\x12\x13\n\x0b\x64istributed\x18\x05 \x01(\x08\" \n\x0fListStoresReply\x12\r\n\x05names\x18\x01 \x03(\t\"Q\n\rInsertRequest\x12\r\n\x05store\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12\x0e\n\x06vector\x18\x03 \x03(\x02\x12\x15\n\rmetadata_json\x18\x04 \x01(\t\"i\n\x12InsertBatchRequest\x12\r\n\x05store\x18\x01 \x01(\t\x12\x0b\n\x03ids\x18\x02 \x03(\t\x12\x13\n\x0bvectors_f32\x18\x03 \x01(\x0c\x12\x0b\n\x03\x64im\x18\x04 \x01(\r\x12\x15\n\rmetadata_json\x18\x05 \x03(\t\"*\n\rDeleteRequest\x12\r\n\x05store\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\"\x92\x01\n\rSearchRequest\x12\r\n\x05store\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\t\n\x01k\x18\x03 \x01(\r\x12\x0e\n\x06metric\x18\x04 \x01(\t\x12\x13\n\x0b\x66ilter_json\x18\x05 \x01(\t\x12\x0b\n\x03seq\x18\x06 \x01(\x04\x12\x0e\n\x06nprobe\x18\x07 \x01(\r\x12\x15\n\rrecall_target\x18\x08 \x01(\x02\":\n\x03Hit\x12\n\n\x02id\x18\x01 \x01(\t\x12\x10\n\x08\x64istance\x18\x02 \x01(\x02\x12\x15\n\rmetadata_json\x18\x03 \x01(\t\"B\n\x0bSearchReply\x12\x17\n\x04hits\x18\x01 \x03(\x0b\x32\t.evdb.Hit\x12\x0b\n\x03seq\x18\x02 \x01(\x04\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"\x9c\x01\n\x12SearchBatchRequest\x12\r\n\x05store\x18\x01 \x01(\t\x12\x13\n\x0bvectors_f32\x18\x02 \x01(\x0c\x12\x0b\n\x03\x64im\x18\x03 \x01(\r\x12\t\n\x01k\x18\x04 \x01(\r\x12\x0e\n\x06metric\x18\x05 \x01(\t\x12\x13\n\x0b\x66ilter_json\x18\x06 \x01(\t\x12\x0e\n\x06nprobe\x18\x07 \x01(\r\x12\x15\n\rrecall_target\x18\x08 \x01(\x02\"P\n\x10SearchBatchReply\x12\r\n\x05\x63ount\x18\x01 \x01(\r\x12\t\n\x01k\x18\x02 \x01(\r\x12\x0b\n\x03ids\x18\x03 \x03(\t\x12\x15\n\rdistances_f32\x18\x04 \x01(\x0c\" \n\nStatsReply\x12\x12\n\nstats_json\x18\x01 \x01(\t\"3\n\rBackupRequest\x12\r\n\x05store\x18\x01 \x01(\t\x12\x13\n\x0b\x62\x61\x63kup_name\x18\x02 \x01(\t\"\x1b\n\x0b\x42\x61\x63kupReply\x12\x0c\n\x04path\x18\x01 \x01(\t\"7\n\x0eRestoreRequest\x12\x13\n\x0b\x62\x61\x63kup_file\x18\x01 \x01(\t\x12\x10\n\x08new_name\x18\x02 \x01(\t\"(\n\x10ListBackupsReply\x12\x14\n\x0c\x62\x61\x63kups_json\x18\x01 \x01(\t\"2\n\x0bHealthReply\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65tail_json\x18\x02 \x01(\t2\x96\x06\n\x0b\x45rlVectorDB\x12(\n\x06Health\x12\x0b.evdb.Empty\x1a\x11.evdb.HealthReply\x12\x30\n\nListStores\x12\x0b.evdb.Empty\x1a\x15.evdb.ListStoresReply\x12\x30\n\x06Search\x12\x13.evdb.SearchRequest\x1a\x11.evdb.SearchReply\x12?\n\x0bSearchBatch\x12\x18.evdb.SearchBatchRequest\x1a\x16.evdb.SearchBatchReply\x12:\n\x0cStreamSearch\x12\x13.evdb.SearchRequest\x1a\x11.evdb.SearchReply(\x01\x30\x01\x12)\n\x05Stats\x12\x0e.evdb.StoreRef\x1a\x10.evdb.StatsReply\x12:\n\x0b\x43reateStore\x12\x18.evdb.CreateStoreRequest\x1a\x11.evdb.StatusReply\x12\x30\n\x06Insert\x12\x13.evdb.InsertRequest\x1a\x11.evdb.StatusReply\x12:\n\x0bInsertBatch\x12\x18.evdb.InsertBatchRequest\x1a\x11.evdb.StatusReply\x12\x30\n\x06\x44\x65lete\x12\x13.evdb.DeleteRequest\x1a\x11.evdb.StatusReply\x12)\n\x04Sync\x12\x0e.evdb.StoreRef\x1a\x11.evdb.StatusReply\x12\x30\n\x0b\x44\x65leteStore\x12\x0e.evdb.StoreRef\x1a\x11.evdb.StatusReply\x12\x30\n\x06\x42\x61\x63kup\x12\x13.evdb.BackupRequest\x1a\x11.evdb.BackupReply\x12\x32\n\x07Restore\x12\x14.evdb.RestoreRequest\x1a\x11.evdb.StatusReply\x12\x32\n\x0bListBackups\x12\x0b.evdb.Empty\x1a\x16.evdb.ListBackupsReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'evdb_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=20
  _EMPTY._serialized_end=27
  _STATUSREPLY._serialized_start=29
  _STATUSREPLY._serialized_end=71
  _STOREREF._serialized_start=73
  _STOREREF._serialized_end=97
  _CREATESTOREREQUEST._serialized_start=99
  _CREATESTOREREQUEST._serialized_end=204
  _LISTSTORESREPLY._serialized_start=206
  _LISTSTORESREPLY._serialized_end=238
  _INSERTREQUEST._serialized_start=240
  _INSERTREQUEST._serialized_end=321
  _INSERTBATCHREQUEST._serialized_start=323
  _INSERTBATCHREQUEST._serialized_end=428
  _DELETEREQUEST._serialized_start=430
  _DELETEREQUEST._serialized_end=472
  _SEARCHREQUEST._serialized_start=475
  _SEARCHREQUEST._serialized_end=621
  _HIT._serialized_start=623
  _HIT._serialized_end=681
  _SEARCHREPLY._serialized_start=683
  _SEARCHREPLY._serialized_end=749
  _SEARCHBATCHREQUEST._serialized_start=752
  _SEARCHBATCHREQUEST._serialized_end=908
  _SEARCHBATCHREPLY._serialized_start=910
  _SEARCHBATCHREPLY._serialized_end=990
  _STATSREPLY._serialized_start=992
  _STATSREPLY._serialized_end=1024
  _BACKUPREQUEST._serialized_start=1026
  _BACKUPREQUEST._serialized_end=1077
  _BACKUPREPLY._serialized_start=1079
  _BACKUPREPLY._serialized_end=1106
  _RESTOREREQUEST._serialized_start=1108
  _RESTOREREQUEST._serialized_end=1163
  _LISTBACKUPSREPLY._serialized_start=1165
  _LISTBACKUPSREPLY._serialized_end=1205
  _HEALTHREPLY._serialized_start=1207
  _HEALTHREPLY._serialized_end=1257
  _ERLVECTORDB._serialized_start=1260
  _ERLVECTORDB._serialized_end=2050
# @@protoc_insertion_point(module_scope)
